"""The public surface of envpool_tpu_torch against envpool_tpu.

Specs, spaces, dtypes, adapter outputs and error paths of PongLite-v5 must
match the JAX package's; the port must import neither JAX nor envpool_tpu,
and must refuse to fall back to the CPU when a CUDA device is missing.
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch

TASK = "PongLite-v5"


def _specs(**kwargs):
    return (
        envpool_tpu.make_spec(TASK, **kwargs),
        envpool_tpu_torch.make_spec(TASK, device="cpu", **kwargs),
    )


@pytest.mark.parametrize(
    "kwargs",
    [{"num_envs": 2}, {"num_envs": 3, "gray_scale": False, "stack_num": 2,
                       "img_height": 42, "full_action_space": True}],
)
def test_spec_surface_matches_jax(kwargs):
    jspec, tspec = _specs(**kwargs)
    assert list(jspec.state_array_spec) == list(tspec.state_array_spec)
    for k, js in jspec.state_array_spec.items():
        ts = tspec.state_array_spec[k]
        assert (js.dtype, js.shape, js.is_discrete) == (ts.dtype, ts.shape, ts.is_discrete), k
        np.testing.assert_array_equal(js.minimum, ts.minimum)
        np.testing.assert_array_equal(js.maximum, ts.maximum)
        assert ts.torch_dtype == torch.from_numpy(np.zeros(0, ts.dtype)).dtype
    assert repr(jspec.action_array_spec) == repr(tspec.action_array_spec)
    jcfg, tcfg = jspec.config._asdict(), tspec.config._asdict()
    assert tcfg.pop("device") == "cpu"
    assert jcfg == tcfg
    assert jspec.observation_space == tspec.observation_space
    assert jspec.action_space == tspec.action_space
    assert repr(jspec.observation_spec()) == repr(tspec.observation_spec())
    assert repr(jspec.action_spec()) == repr(tspec.action_spec())
    assert jspec.reward_threshold == tspec.reward_threshold


def test_registry_surface():
    from envpool_tpu.core.registry import registry
    from envpool_tpu_torch.core.registry import registry as torch_registry

    # dm_control: all 51 ids, the five Dog ids among them.
    dmc = {t for t, (path, _, _) in torch_registry.specs.items()
           if path.endswith(".mujoco_dmc")}
    jax_dmc = {t for t, (path, _, _) in registry.specs.items() if path.endswith(".mujoco_dmc")}
    assert len(dmc) == 51 and dmc == jax_dmc
    assert {"DogStand-v1", "DogWalk-v1", "DogTrot-v1", "DogRun-v1", "DogFetch-v1"} <= dmc
    ported = [
        t for t in envpool_tpu.list_all_envs()
        if t in (TASK, "Dummy-v0")
        or t.startswith("Machine2600")
        or registry.specs[t][0].endswith(
            (".classic_control", ".mujoco_gym", ".mujoco_dmc", ".toy_text", ".procgen",
             ".vizdoom", ".minigrid", ".board", ".highway", ".robotics", ".metaworld"))
    ]
    assert envpool_tpu_torch.list_all_envs() == ported
    with pytest.raises(ValueError):
        envpool_tpu_torch.make(TASK, env_type="gym3", device="cpu")
    assert set(envpool_tpu.__all__) - {"TpuEnv"} == set(envpool_tpu_torch.__all__) - {
        "TorchEnv"
    }


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"task_id": "NoSuchGame-v5"}, ValueError),
        ({"no_such_key": 1}, TypeError),
        ({"num_envs": 2, "batch_size": 3}, ValueError),
        ({"seed": 2**31}, ValueError),
        ({"num_envs": 2, "env_seed": [1]}, ValueError),
        ({"sharding": "dp"}, NotImplementedError),
        ({"from_pixels": True}, ValueError),  # PongLite-v5 has no physics model
    ],
)
def test_error_paths_match_jax(kwargs, error):
    kwargs = dict(kwargs)
    task = kwargs.pop("task_id", TASK)
    with pytest.raises(error):
        envpool_tpu_torch.make(task, env_type="gymnasium", device="cpu", **kwargs)
    if error is not NotImplementedError:
        with pytest.raises(error):
            envpool_tpu.make(task, env_type="gymnasium", **kwargs)


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envpool_tpu_torch.make_dm(TASK, num_envs=2, device="cuda")


def test_import_loads_neither_jax_nor_envpool_tpu():
    """Nor, making and stepping a robotics id (the Shadow Hand's committed
    model) and a MetaWorld id on the CPU, gymnasium_robotics or mujoco."""
    code = (
        "import sys, numpy as np, envpool_tpu_torch, envpool_tpu_torch.interop;"
        "import envpool_tpu_torch.envs.atari.obs_ties;"
        "[envpool_tpu_torch.make(t, env_type='gymnasium', num_envs=2, device='cpu')"
        " .step(np.zeros((2, n), np.float32)) for t, n in"
        " (('HandReach-v3', 20), ('MetaWorld/PickPlace-v3', 4))];"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'envpool_tpu', 'gymnasium_robotics', 'mujoco')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_gymnasium_outputs_match_jax_structure():
    jpool = envpool_tpu.make(TASK, env_type="gymnasium", num_envs=2, seed=0)
    tpool = envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=2, seed=0, device="cpu")
    for out_j, out_t in ((jpool.reset(), tpool.reset()),
                         (jpool.step(np.ones(2, np.int32)), tpool.step(np.ones(2, np.int32)))):
        assert len(out_j) == len(out_t)
        for a, b in zip(out_j, out_t):
            if isinstance(a, dict):
                assert set(a) == set(b)
                a, b = a["players"]["env_id"], b["players"]["env_id"]
            assert isinstance(b, np.ndarray)
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
    assert tpool.observation_space == jpool.observation_space
    assert tpool.action_space == jpool.action_space


def test_dm_outputs_match_jax_structure():
    jpool = envpool_tpu.make_dm(TASK, num_envs=2, seed=0)
    tpool = envpool_tpu_torch.make_dm(TASK, num_envs=2, seed=0, device="cpu")
    for tj, tt in ((jpool.reset(), tpool.reset()),
                   (jpool.step(np.zeros(2, np.int32)), tpool.step(np.zeros(2, np.int32)))):
        assert type(tj) is type(tt)
        assert tj.observation._fields == tt.observation._fields
        np.testing.assert_array_equal(tj.step_type, tt.step_type)
        assert tt.observation.obs.shape == (2, 4, 84, 84)
    assert repr(jpool.observation_spec()) == repr(tpool.observation_spec())


def test_adapter_options_and_unported_methods(tmp_path):
    pool = envpool_tpu_torch.make(
        TASK, env_type="gymnasium", num_envs=3, device="cpu", numpy_output=False
    )
    obs, info = pool.reset()
    assert isinstance(obs, torch.Tensor) and obs.dtype == torch.uint8
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pool.reset(seed=3)
    assert any("ignored" in str(w.message) for w in caught)
    obs, info = pool.reset(options={"reset_mask": np.array([False, True, True])})
    assert info["env_id"].tolist() == [1, 2]
    with pytest.raises(ValueError):
        pool.reset(options={"reset_mask": np.zeros(3, bool)})
    with pytest.raises(ValueError):
        pool.step(np.zeros(2, np.int32))
    obs, rew, term, trunc, info = pool.step({"action": torch.zeros(3, dtype=torch.int32)})
    assert rew.dtype == torch.float32 and term.dtype == torch.bool
    # render, save_state and load_state are ported (their own tests:
    # tests/test_torch_wrappers_render.py)
    assert pool.render().shape == (3, 210, 160, 3)
    pool.save_state(str(tmp_path / "pool.npz"))
    pool.load_state(str(tmp_path / "pool.npz"))
    assert isinstance(pool, envpool_tpu_torch.GymnasiumEnvPool)
    assert isinstance(pool, envpool_tpu_torch.EnvPool)
