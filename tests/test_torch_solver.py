"""The port's constraint solver (``contact_solver="mujoco"``) against the
JAX package.

``constraint_force`` of both packages on the same states (JAX's jitted once
for one env, the port's batched, with its plain PGS): the joint-space
constraint force and the smooth acceleration within ``FORCE_TOL`` of
JAX's, relative to ``1 + |jax|``.  The sweeps sum each row's dot product in
another order than the JAX loop, and 40 of them carry that rounding no
farther than float32 rounding of forces up to ~5e4 (Hopper pressed into
the floor).  One env step of Ant-v4 (RK4, its model's integrator, and
Euler) and of WalkerWalk-v1, state, obs and reward, is held to
``STEP_TOL``, the physics tests' bar, against JAX's ``step_env`` with
JAX's physics built from its jitted single-env pieces.  The plain
version of the PGS kernel (formation, sweeps, ``Jᵀf``) is held to a numpy
transcription of JAX's ``constraint_force`` after the rows; the kernel
against the plain version runs only on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
from envpool_tpu.physics import dynamics as jdyn
from envpool_tpu.physics import solver as jsol
from envpool_tpu.physics.kinematics import integrate_qpos
from envpool_tpu.core.registry import registry as jax_registry
import envpool_tpu_torch
from envpool_tpu_torch.physics import dynamics as tdyn
from envpool_tpu_torch.physics import solver as tsol
from envpool_tpu_torch.physics.model import load_model
from envpool_tpu_torch.ops.cuda_pgs import pgs_form, pgs_plain, pgs_solve, pgs_solve_plain
from envpool_tpu_torch.physics.linalg import factor_solve, spd_factor, spd_solve

FORCE_TOL = 1e-4
STEP_TOL = 1e-4
H = 0.002


def _states(task, n, seed):
    """``n`` states of ``task``: JAX's resets, the base lowered into the
    floor and a random qvel, so that feet press into the ground."""
    jenv = envpool_tpu.make_spec(task, num_envs=n, seed=seed).env
    q0 = np.asarray(jenv.model.qpos0, np.float32)
    r = np.random.default_rng(seed)
    q = q0 + r.uniform(-0.1, 0.1, (n, len(q0))).astype(np.float32)
    height = {"Ant-v4": (2, 0.1, 0.2), "Hopper-v4": (1, -0.1, 0.05)}[task]
    q[:, height[0]] = r.uniform(*height[1:], n)
    qd = r.normal(0, 1, (n, jenv.model.nv)).astype(np.float32)
    ctrl = r.uniform(-1, 1, (n, jenv.model.nu)).astype(np.float32)
    return jenv, q, qd, ctrl


@functools.cache
def _jax_constraint_force(task):
    jenv = envpool_tpu.make_spec(task, contact_solver="mujoco").env
    cp = jdyn.ContactParams(solver="mujoco")

    @jax.jit
    def one(q, qd, ctrl):
        M, tau, _, k = jdyn._smooth(jenv.model, q, qd, ctrl, cp)
        return jsol.constraint_force(jenv.model, k, q, qd, M, tau, H, 40)

    return one


@pytest.mark.parametrize("task", ["Hopper-v4", "Ant-v4"])
def test_constraint_force_matches_jax(task):
    n = 6
    _, q, qd, ctrl = _states(task, n, seed=len(task))
    fn = _jax_constraint_force(task)
    want = [np.stack(x) for x in zip(*(
        jax.device_get(fn(*(jnp.asarray(a[i]) for a in (q, qd, ctrl)))) for i in range(n)))]
    tenv = envpool_tpu_torch.make_spec(task, device="cpu", contact_solver="mujoco").env
    model = tenv.model
    tq, tqd, tctrl = (torch.as_tensor(a) for a in (q, qd, ctrl))
    M, tau, d_con, k = tdyn._smooth(model, tq, tqd, tctrl, tenv.contact)
    assert d_con is None  # no penalty contact damping in solver mode
    before = pgs_solve.launches
    got = tsol.constraint_force(model, k, tq, tqd, M, tau, H, 40)
    assert pgs_solve.launches == before  # the plain sweeps on the CPU
    _, _, _, active = tsol.solver_rows(model, k, tq, tqd, H)
    assert bool(active[:, :4 * len(model.con_body)].any(1).all())  # every env in contact
    for name, g, w in zip(("qfrc_constraint", "qacc_smooth"), got, want):
        np.testing.assert_array_less(np.abs(g.numpy() - w), FORCE_TOL * (1 + np.abs(w)),
                                     err_msg=name)
    assert np.abs(want[0]).max() > 100.0  # the solver pushes


def test_penalty_terms_dropped_in_solver_mode():
    """Solver mode drops the ground contacts' penalty force and the joint
    limits' penalty spring from τ and keeps the rest."""
    model = load_model("ant.xml")
    n = 3
    r = np.random.default_rng(0)
    q = torch.as_tensor(np.tile(model.qpos0, (n, 1)), dtype=torch.float32)
    q[:, 2] = 0.2  # in the ground
    q[:, 7:] = 2.0  # every hinge past its limit
    qd = torch.as_tensor(r.normal(0, 1, (n, model.nv)), dtype=torch.float32)
    ctrl = torch.zeros(n, model.nu)
    mt = tdyn.model_tensors(model, q.device, q.dtype)
    pen = tdyn._smooth(model, q, qd, ctrl, tdyn.ContactParams())
    sol = tdyn._smooth(model, q, qd, ctrl, tdyn.ContactParams(solver="mujoco"))
    v_con = tdyn._vel_from_kin(mt, pen[3], qd)[2]
    tau_con, _ = tdyn._contact_forces_shared(mt, tdyn.ContactParams(), pen[3].centers, v_con,
                                             tdyn._jac_from_kin(mt, pen[3])[2])
    limit = tdyn._passive_forces(mt, q, qd) - tdyn._passive_forces(mt, q, qd, limit_penalty=False)
    assert float(limit.abs().min(1).values.max()) == 0.0  # the free joint's dofs
    assert float(limit.abs().max()) > 100.0 and float(tau_con.abs().max()) > 1.0
    torch.testing.assert_close(pen[1] - sol[1], tau_con + limit, rtol=1e-5, atol=1e-3)


def test_limit_rows_of_unlimited_joints_stay_finite():
    """dm_control's cartpole: a limited slide and an unlimited hinge, whose
    row (±inf bounds) must carry finite numbers and stay inactive."""
    model = load_model("dmc:cartpole")
    q = torch.tensor([[0.0, 3.0], [1.81, -40.0], [-1.9, 0.1]])
    qd = torch.tensor([[1.0, -2.0], [5.0, 1.0], [-3.0, 0.0]])
    J, aref, R, active = tsol._limit_rows(model, q, qd, H)
    assert J.shape == (3, 2, 2)
    assert bool(torch.isfinite(aref).all() and torch.isfinite(R).all())
    assert active.tolist() == [[False, False], [True, False], [True, False]]
    assert J[1, 0].tolist() == [-1.0, 0.0] and J[2, 0].tolist() == [1.0, 0.0]
    f = pgs_plain(torch.eye(2).expand(3, 2, 2), aref, R, 1 + R, active, 40)
    assert bool(torch.isfinite(f).all()) and float(f[:, 1].abs().max()) == 0.0


@functools.cache
def _jax_substeps(model, contact, substeps):
    """``(run, count)``: JAX's physics step of one env cut into ``count``
    calls of ``run`` per model timestep, each jitted once: Euler's
    ``substeps`` substeps (``dynamics._step_impl`` at ``nsteps=1``), or one
    RK4 substep composed of JAX's jitted ``forward`` and ``integrate_qpos``
    as ``_step_impl``'s ``rk4`` composes them.  (A whole JAX env step in
    solver mode takes a minute to trace and compile on a CPU.)"""
    if model.integrator == 0:
        return jax.jit(lambda q, qd, c: jdyn._step_impl(model, q, qd, c, substeps, contact, 1)), 1
    h = model.timestep / substeps
    fwd = jax.jit(lambda q, qd, c: jdyn.forward(model, q, qd, c, contact))
    integ = jax.jit(lambda q, qd, dt: integrate_qpos(model, q, qd, dt), static_argnums=2)

    def rk4(q, qd, c):
        a1 = fwd(q, qd, c)
        q2, qd2 = integ(q, qd, h / 2), qd + (h / 2) * a1
        a2 = fwd(q2, qd2, c)
        q3, qd3 = integ(q, qd2, h / 2), qd + (h / 2) * a2
        a3 = fwd(q3, qd3, c)
        q4, qd4 = integ(q, qd3, h), qd + h * a3
        a4 = fwd(q4, qd4, c)
        qd_avg = (qd + 2 * qd2 + 2 * qd3 + qd4) / 6
        qacc = (a1 + 2 * a2 + 2 * a3 + a4) / 6
        return integ(q, qd_avg, h), qd + h * qacc

    return rk4, substeps


def _jax_phys_step(model, qpos, qvel, ctrl, substeps, contact, nsteps):
    """JAX's ``dynamics.step`` of one env, from its jitted pieces."""
    run, count = _jax_substeps(model, contact, substeps)
    for _ in range(nsteps * count):
        qpos, qvel = run(qpos, qvel, ctrl)
    return qpos, qvel


def _jax_env_steps(jenv, module, monkeypatch, state, action):
    """JAX's ``step_env`` of every env of a host state, one env at a time,
    with the physics of :func:`_jax_phys_step` patched into ``module``."""
    monkeypatch.setattr(module, "phys_step", _jax_phys_step)
    outs = []
    for i in range(len(action)):
        st = jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), state)
        out = jenv.step_env(st, jnp.asarray(action[i]), jax.random.PRNGKey(i))
        outs.append({"state": out.state, "obs": out.obs, "reward": out.reward,
                     "terminated": out.terminated})
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *jax.device_get(outs))


def _assert_close(want, got, tol, what):
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        if np.issubdtype(np.asarray(w).dtype, np.floating):
            np.testing.assert_array_less(np.abs(g - w), tol * (1 + np.abs(w)) + 1e-30,
                                         err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("integrator", ["model", "euler"])
def test_ant_env_step_matches_jax(integrator, monkeypatch):
    """One env step of four Ant-v4 envs in solver mode, RK4 (the model's)
    and Euler, against JAX's ``step_env``: three envs low enough for feet
    within the contact margin, one in the air."""
    from envpool_tpu.envs.mujoco_gym import base as jbase

    n = 4
    jenv = envpool_tpu.make_spec("Ant-v4", num_envs=n, contact_solver="mujoco",
                                 integrator=integrator).env
    tenv = envpool_tpu_torch.make_spec("Ant-v4", num_envs=n, device="cpu",
                                       contact_solver="mujoco", integrator=integrator).env
    assert tenv.model.integrator == jenv.model.integrator == (integrator == "model")
    r = np.random.default_rng(7)
    q = np.tile(np.asarray(jenv.model.qpos0, np.float32), (n, 1))
    q += r.uniform(-0.1, 0.1, q.shape).astype(np.float32)
    q[:, 2] = [0.12, 0.16, 0.2, 0.9]
    qd = r.normal(0.0, 1.0, (n, jenv.model.nv)).astype(np.float32)
    state = {"qpos": q, "qvel": qd, "qpos0": q, "qvel0": qd}
    action = r.uniform(-1.0, 1.0, (n, 8)).astype(np.float32)
    depth = tdyn.contact_depths(tenv.model, torch.as_tensor(q))
    assert (depth > -0.02).any(1).tolist() == [True, True, True, False]
    want = _jax_env_steps(jenv, jbase, monkeypatch, state, action)
    before = pgs_solve.launches
    got = tenv.step_env({k: torch.as_tensor(v) for k, v in state.items()},
                        torch.as_tensor(action), {})
    assert pgs_solve.launches == before
    _assert_close(want["state"], got.state, STEP_TOL, "state")
    _assert_close(want["obs"], got.obs, STEP_TOL, "obs")
    _assert_close({"reward": want["reward"], "terminated": want["terminated"]},
                  {"reward": got.reward, "terminated": got.terminated}, STEP_TOL, "")
    assert np.abs(want["state"]["qpos"] - q).max() > 1e-3


def test_dmc_walker_env_step_matches_jax(monkeypatch):
    """WalkerWalk-v1 in solver mode (Euler, 10 physics steps per control
    step, feet on the floor, limited joints) against JAX's ``step_env``."""
    from envpool_tpu.envs.mujoco_dmc import base as jbase

    n = 3
    jenv = jax_registry._env("WalkerWalk-v1", num_envs=n, contact_solver="mujoco")
    tenv = envpool_tpu_torch.make_spec("WalkerWalk-v1", num_envs=n, device="cpu",
                                       contact_solver="mujoco").env
    r = np.random.default_rng(3)
    q = np.zeros((n, jenv.model.nq), np.float32)
    q[:, 0] = [-0.05, 0.0, 0.3]  # rootz: the feet in the floor, on it, in the air
    q[:, 3:] = r.uniform(-0.3, 0.3, (n, jenv.model.nq - 3))
    qd = r.normal(0.0, 1.0, (n, jenv.model.nv)).astype(np.float32)
    jst = jax.device_get(jax.vmap(jenv.reset_env)(jax.random.split(jax.random.PRNGKey(0), n))[0])
    state = dict(jst, qpos=q, qvel=qd)
    action = r.uniform(-1.0, 1.0, (n, 6)).astype(np.float32)
    want = _jax_env_steps(jenv, jbase, monkeypatch, state, action)
    got = tenv.step_env(jax.tree_util.tree_map(torch.as_tensor, state),
                        torch.as_tensor(action), {})
    _assert_close({k: want["state"][k] for k in ("qpos", "qvel")}, got.state, STEP_TOL, "state")
    _assert_close(want["obs"], got.obs, STEP_TOL, "obs")
    _assert_close({"reward": want["reward"]}, {"reward": got.reward}, STEP_TOL, "")


def test_solver_configs_reach_the_physics():
    env = envpool_tpu_torch.make_spec("Ant-v4", device="cpu", contact_solver="mujoco").env
    assert env.contact.solver == "mujoco" and env.contact.sol_iters == 40
    env = envpool_tpu_torch.make_spec("CheetahRun-v1", device="cpu", contact_solver="mujoco",
                                      contact_sol_iters=12).env
    assert env.contact == tdyn.ContactParams(kp=2e4, kd=2e2, solver="mujoco", sol_iters=12)


def _random_systems(n, nr, nv, dtype, device, seed, share=0.5):
    """``(M, [J, L, ok, qacc_smooth, aref, R, active])``: ``n`` random
    constraint systems of ``nr`` rows over ``nv`` dofs, a random SPD ``M``
    and about ``share`` of the rows active, made with numpy."""
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, nv, nv))
    M = B @ B.transpose(0, 2, 1) + nv * np.eye(nv)
    J = r.normal(size=(n, nr, nv))
    qacc = r.normal(size=(n, nv))
    aref = r.normal(size=(n, nr))
    R = 0.1 + r.uniform(size=(n, nr))
    active = torch.as_tensor(r.uniform(size=(n, nr)) < share, device=device)
    L, ok = spd_factor(torch.as_tensor(M, dtype=dtype, device=device))
    t = [torch.as_tensor(x, dtype=dtype, device=device) for x in (J, qacc, aref, R)]
    return M, [t[0], L, ok, t[1], t[2], t[3], active]


def _jax_after_rows(M, J, qacc, aref, R, active, iterations):
    """A numpy transcription of JAX's ``constraint_force`` after the rows
    (``envpool_tpu/physics/solver.py``): ``M⁻¹Jᵀ`` by a dense solve, the
    dense loop over every row in order, ``Jᵀf``."""
    A = J @ np.linalg.solve(M, J.T)
    b = J @ qacc - aref
    diag = np.maximum(np.diag(A) + R, 1e-10)
    f = np.zeros(len(b))
    for _ in range(iterations):
        for i in range(len(b)):
            g = A[i] @ f + b[i] + R[i] * f[i]
            f[i] = max(0.0, f[i] - g / diag[i]) * active[i]
    return f, J.T @ f


def test_plain_sweeps_match_jax_loop():
    """The plain sweeps against a direct transcription of the JAX loop
    (every row, one-hot rows), in float64: equal to rounding."""
    _, (J, L, ok, qacc, aref, R, active) = _random_systems(3, 9, 4, torch.float64, "cpu",
                                                           seed=1)
    A, b, diag = pgs_form(J, L, ok, qacc, aref, R)
    got = pgs_plain(A, b, R, diag, active, 40)
    for e in range(3):
        f = np.zeros(9)
        a, bb, rr, dd, act = (x[e].numpy() for x in (A, b, R, diag, active))
        for _ in range(40):
            for i in range(9):
                g = a[i] @ f + bb[i] + rr[i] * f[i]
                f[i] = max(0.0, f[i] - g / dd[i]) * act[i]
        np.testing.assert_allclose(got[e].numpy(), f, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nr, nv", [(12, 5), (40, 14)])
def test_plain_pgs_matches_jax_constraint_force(nr, nv):
    """The kernel's plain version (the dense formation from ``M``'s
    factor, the sweeps, ``Jᵀf``) on random float64 systems against the
    numpy transcription of JAX's ``constraint_force`` after the rows:
    forces and ``qfrc`` within 1e-12."""
    M, system = _random_systems(4, nr, nv, torch.float64, "cpu", seed=nr)
    f, qfrc = pgs_solve_plain(*system, 40)
    J, _, _, qacc, aref, R, active = (x.numpy() for x in system)
    assert 0 < active.sum(1).min() and active.sum(1).max() < nr
    for e in range(4):
        want_f, want_q = _jax_after_rows(M[e], J[e], qacc[e], aref[e], R[e], active[e], 40)
        assert np.abs(want_f).max() > 0.1  # the solver pushes
        np.testing.assert_allclose(f[e].numpy(), want_f, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(qfrc[e].numpy(), want_q, rtol=1e-12, atol=1e-12)


def test_pgs_nan_only_where_not_spd():
    """An env whose ``M`` is not SPD gets NaN in ``qfrc`` and on its active
    rows' forces, 0 on its inactive rows; every other env is finite."""
    M, (J, L, ok, qacc, aref, R, active) = _random_systems(4, 20, 6, torch.float64, "cpu",
                                                           seed=5)
    M[2, 0, 0] = -1.0
    L, ok = spd_factor(torch.as_tensor(M))
    qacc = factor_solve(L, ok, qacc)
    assert ok.tolist() == [True, True, False, True]
    f, qfrc = pgs_solve(J, L, ok, qacc, aref, R, active, 40)
    bad = ~ok
    assert bool(qfrc[bad].isnan().all()) and bool(torch.isfinite(qfrc[ok]).all())
    assert bool(f[bad][active[bad]].isnan().all()) and bool(torch.isfinite(f[ok]).all())
    assert float(f.masked_fill(active, 0).abs().max()) == 0.0


@pytest.mark.parametrize("columns", [None, 1, 9])
def test_spd_factor_then_solve_equals_spd_solve(columns):
    """``spd_factor`` and a solve with its factor give ``spd_solve``'s
    numbers bit for bit (NaN rows where not SPD included)."""
    r = np.random.default_rng(11)
    B = r.normal(size=(5, 7, 7))
    M = torch.as_tensor(B @ B.transpose(0, 2, 1) + 0.1 * np.eye(7), dtype=torch.float32)
    M[3] = -M[3]
    b = torch.as_tensor(r.normal(size=(5, 7) if columns is None else (5, 7, columns)),
                        dtype=torch.float32)
    want = spd_solve(M, b)
    L, ok = spd_factor(M)
    got = factor_solve(L, ok, b)
    assert bool(want[3].isnan().all()) and bool(torch.isfinite(want[ok]).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    x = torch.cholesky_solve(b[..., None] if columns is None else b, L)
    torch.testing.assert_close(x.reshape(want.shape)[ok], want[ok], rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the PGS kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nr", [9, 108, 300])
def test_pgs_kernel_matches_plain_on_card(cuda_device, dtype, nr):
    """Float and double, active rows within and past what an env keeps
    resident (300 rows at half active: past the kernel's resident rows):
    forces and ``qfrc`` of the kernel against its plain version."""
    _, system = _random_systems(64, nr, 14, dtype, cuda_device, seed=nr)
    before = pgs_solve.launches
    got = pgs_solve(*system, 40)
    torch.cuda.synchronize()
    assert pgs_solve.launches == before + 1
    want = pgs_solve_plain(*system, 40)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    active = system[-1]
    assert float(got[0].masked_fill(active, 0).abs().max()) == 0.0
    if nr == 300:
        resident = pgs_solve.occupancy(64, 14, dtype)["resident_rows"]
        assert int(active.sum(1).min()) > resident
