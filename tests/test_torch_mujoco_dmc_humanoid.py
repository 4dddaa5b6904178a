"""The port's dm_control humanoids against the JAX package, and CheetahRun
on the card against the CPU.

The engine check of ``tests/test_torch_mujoco_dmc.py`` (one step from
JAX's state within 1e-4 · (1 + |jax|), integer and bool fields equal,
across an auto-reset) on HumanoidRun, HumanoidRunPureState (the same
model, with the state as its obs) and HumanoidCMUStand (the 56-actuator
CMU skeleton).  Their JAX engines take the longest to compile (20-40 s
each on a CPU), so they have a file of their own.
"""

import numpy as np
import pytest
import torch

import envpool_tpu_torch
from envpool_tpu_torch.core.engine import Engine, _tree_map
from test_torch_mujoco_dmc import check_step_matches_jax


@pytest.mark.parametrize(
    "task", ["HumanoidRun-v1", "HumanoidRunPureState-v1", "HumanoidCMUStand-v1"]
)
def test_step_matches_jax_across_auto_reset(task):
    check_step_matches_jax(task, n=4, steps=4, episode=2)


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cheetah_card_step_matches_cpu():
    """CheetahRun-v1 at 1024 envs: the card's engine step from the card's
    state after 20 random steps, against the CPU's from the same state and
    action.  Every env whose substep does not cross a penalty-force switch
    differently on the two devices (``dynamics.switch_sides``, at most 1%)
    agrees within 1e-4 · (1 + |cpu|) in its state, obs and reward.  Both
    devices reset from the committed bank, bit for bit alike."""
    from envpool_tpu_torch.physics import dynamics

    n, tol = 1024, 1e-4
    card = envpool_tpu_torch.make_spec("CheetahRun-v1", num_envs=n, seed=5).env
    cpu = envpool_tpu_torch.make_spec("CheetahRun-v1", num_envs=n, seed=5, device="cpu").env
    ceng, teng = Engine(card), Engine(cpu)
    ps = ceng.init()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.bank, cpu.bank))
    gen = torch.Generator().manual_seed(5)

    def act():
        return {"action": torch.rand(n, card.model.nu, generator=gen) * 2 - 1}

    for _ in range(20):
        ps, _ = ceng.step(ps, {"action": act()["action"].cuda()})
    a = act()
    host = type(ps)(*(_tree_map(lambda x: x.cpu(), f) for f in (
        ps.env_state, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)))
    ps_card, got = ceng.step(ps, {"action": a["action"].cuda()})
    ps_cpu, want = teng.step(host, a)
    q, qd = host.env_state["qpos"], host.env_state["qvel"]
    crossed = torch.zeros(n, dtype=torch.bool)
    cq, cqd = q.cuda(), qd.cuda()
    for _ in range(card.frame_skip * card.substeps - 1):
        q, qd = dynamics.step(cpu.model, q, qd, a["action"], 1, cpu.contact)
        cq, cqd = dynamics.step(card.model, cq, cqd, a["action"].cuda(), 1, card.contact)
        crossed |= (dynamics.switch_sides(card.model, cq).cpu()
                    != dynamics.switch_sides(cpu.model, q)).any(1)
    assert int(crossed.sum()) <= n // 100
    keep = ~crossed
    for k, w in want.items():
        g = got[k].cpu()
        if w.is_floating_point():
            err = ((g - w).abs() / (1 + w.abs())).reshape(n, -1).amax(1)
            assert float(err[keep].max()) <= tol, k
        else:
            assert torch.equal(g[keep], w[keep]), k
    for k in ("qpos", "qvel"):
        g, w = ps_card.env_state[k].cpu(), ps_cpu.env_state[k]
        err = ((g - w).abs() / (1 + w.abs())).amax(1)
        assert float(err[keep].max()) <= tol, k
    np.testing.assert_array_equal(want["discount"].numpy(), np.ones(n, np.float32))
