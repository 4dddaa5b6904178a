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
from envpool_tpu_torch.core.engine import Engine
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


_UNPORTED_XML = {
    "ball-joint limits": """
<mujoco><worldbody><body pos="0 0 1">
  <joint type="ball" range="0 30"/><geom type="sphere" size="0.1" mass="1"/>
</body></worldbody></mujoco>""",
}
# A limited spatial tendon (a string): the port's physics steps it.
_STRING_XML = """
<mujoco><worldbody>
  <site name="anchor" pos="0 0 2"/>
  <body pos="0 0 1"><joint name="drop" type="slide" axis="0 0 1"/>
    <geom type="sphere" size="0.1" mass="1"/><site name="bob"/></body>
</worldbody><tendon><spatial limited="true" range="0 1.5">
  <site site="anchor"/><site site="bob"/></spatial></tendon>
<actuator><motor joint="drop" gear="1"/></actuator></mujoco>"""


def test_pools_run_and_unported_options_raise(tmp_path):
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
    # The constraint solver is ported (tests/test_torch_solver.py).
    solver = envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=n, device="cpu",
                                    contact_solver="mujoco")
    solver.reset()
    assert np.isfinite(solver.step(np.zeros((n, 6), np.float32))[0]).all()
    with pytest.raises(ValueError, match="tools.export_models --xml"):
        envpool_tpu_torch.make_spec(TASK, device="cpu", xml_file="model.xml")
    pytest.importorskip("mujoco")
    from envpool_tpu_torch.tools import export_models

    for what, xml in _UNPORTED_XML.items():
        path = tmp_path / "model.xml"
        path.write_text(xml)
        npz = tmp_path / "model.npz"
        with pytest.raises(NotImplementedError, match=what):
            # the extractor or the env, whichever meets the feature first
            export_models.main(["--xml", str(path), "--out", str(npz)])
            envpool_tpu_torch.make_spec(TASK, device="cpu", xml_file=str(npz))
    path = tmp_path / "string.xml"
    path.write_text(_STRING_XML)
    npz = tmp_path / "string.npz"
    export_models.main(["--xml", str(path), "--out", str(npz)])
    env = envpool_tpu_torch.make_spec(TASK, num_envs=n, device="cpu", xml_file=str(npz)).env
    assert env.model.ten_spatial_limited.all()
    eng = Engine(env)
    ps, _ = eng.reset(eng.init(), torch.ones(n, dtype=torch.bool))
    for _ in range(40):
        ps, ts = eng.step(ps, {"action": torch.zeros(n, 1)})
    # the bob starts 1 m below the anchor and falls: the string holds it at
    # its range (1.5 m, the slide at -0.5) plus the penalty's give
    drop = ps.env_state["qpos"][:, 0]
    assert bool(torch.isfinite(ts["obs"]).all()) and bool(((drop < -0.4) & (drop > -0.6)).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            envpool_tpu_torch.make(TASK, env_type="gymnasium")


@pytest.mark.parametrize(
    "task, module, name",
    [("Pusher-v4", "tasks", "body_positions"), ("Humanoid-v4", "humanoid", "_kin")],
)
def test_observations_run_in_full_fp32(monkeypatch, task, module, name):
    """The tree passes of the observations and rewards, like the physics
    step, run their matmuls without TF32 whatever the caller set."""
    import importlib

    mod = importlib.import_module(f"envpool_tpu_torch.envs.mujoco_gym.{module}")
    matmul = torch.backends.cuda.matmul
    seen = []
    inner = getattr(mod, name)

    def spy(*args):
        seen.append(matmul.fp32_precision)
        return inner(*args)

    monkeypatch.setattr(mod, name, spy)
    pool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=2, device="cpu")
    seen.clear()
    before = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        pool.reset()
        pool.step(np.zeros((2, pool.spec.env.model.nu), np.float32))
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    assert seen and set(seen) == {"ieee"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("task", [TASK, "Ant-v4", "Humanoid-v4"])
def test_card_step_matches_cpu(cuda_device, task):
    """One env step of 4096 envs on the card against the CPU port, within
    ``STEP_TOL``, except envs whose substeps fall on different sides of a
    switch of the penalty forces on the card and on the CPU (under 1% of
    them).  On HalfCheetah that holds every other env.  Ant's and
    Humanoid's float32 steps land past ``STEP_TOL`` of a float64 step (on
    the card) on some states on either device, so there an env past
    ``STEP_TOL`` (under 1% of them) passes only where the card's step lies
    within ``STEP_TOL`` of float64, or within 4x the farthest that the
    CPU's float32 steps from its state and from 16 neighbours an ulp or
    two away land from float64.  Over all envs the card's
    float32 steps are as close to float64 as the CPU's: the 99th and
    99.9th percentiles within 2x (plus 1e-6), the count past
    ``STEP_TOL / 2`` within 1.5x (plus 5)."""
    n = 4096
    pool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, device="cpu")
    pool.reset()
    env = pool.spec.env
    r = np.random.default_rng(4)
    nu = env.model.nu
    for _ in range(20):
        pool.step(r.uniform(-1, 1, (n, nu)).astype(np.float32))
    st = pool.pool_state.env_state
    q, qd = st["qpos"], st["qvel"]
    u = torch.as_tensor(r.uniform(-1, 1, (n, nu)).astype(np.float32))
    model, args = env.model, (env.substeps, env.contact, env.frame_skip)

    def rel(a, b):
        a, b = (torch.cat([x.double().cpu() for x in y], 1) for y in (a, b))
        return ((a - b).abs() / (1 + b.abs())).amax(1)

    want = tdyn.step(model, q, qd, u, *args)
    got = tdyn.step(model, *(x.to(cuda_device) for x in (q, qd, u)), *args)
    ref = tdyn.step(model, *(x.to(cuda_device, torch.float64) for x in (q, qd, u)), *args)
    err, card64, cpu64 = rel(got, want), rel(got, ref), rel(want, ref)
    crossed = torch.zeros(n, dtype=torch.bool)
    sq, sqd, cq, cqd = q, qd, q.to(cuda_device), qd.to(cuda_device)
    for _ in range(env.frame_skip * env.substeps - 1):
        sq, sqd = tdyn.step(model, sq, sqd, u, 1, env.contact)
        cq, cqd = tdyn.step(model, cq, cqd, u.to(cuda_device), 1, env.contact)
        crossed |= (tdyn.switch_sides(model, sq) != tdyn.switch_sides(model, cq).cpu()).any(1)
    past = (err > STEP_TOL) & ~crossed
    assert int(crossed.sum()) < 0.01 * n
    if task == TASK:
        assert not bool(past.any()), float(err[past].max())
    elif past.any():
        assert int(past.sum()) < 0.01 * n
        idx = past.nonzero()[:, 0]
        sub = [x[idx] for x in (q, qd, u)]
        sub_ref = [x[idx] for x in ref]
        f32 = rel(tdyn.step(model, *sub, *args), sub_ref)
        gen = torch.Generator().manual_seed(4)
        for _ in range(16):
            moved = [x * (1 + (2 * torch.randint(0, 2, x.shape, generator=gen) - 1) * 2.0**-23)
                     for x in sub[:2]]
            f32 = torch.maximum(f32, rel(tdyn.step(model, *moved, sub[2], *args), sub_ref))
        limit = torch.clamp(4 * f32, min=STEP_TOL)
        assert bool((card64[idx] <= limit).all()), float((card64[idx] / limit).max())
    card64, cpu64 = card64[~crossed], cpu64[~crossed]
    for p in (0.99, 0.999):
        assert float(card64.quantile(p)) <= 2 * float(cpu64.quantile(p)) + 1e-6, p
    assert int((card64 > STEP_TOL / 2).sum()) <= 1.5 * int((cpu64 > STEP_TOL / 2).sum()) + 5
