"""The port's quadruped against the JAX package, and QuadrupedRun-v1 on
the card against the CPU.

QuadrupedRun-v1 (this slice's main path) takes one engine step across an
auto-reset from JAX's states with JAX's reset draws, held by
``test_torch_mujoco_dmc_suite2.check_stiff_step`` (1e-4 · (1 + |jax|), or
float32 at fault as a float64 step shows); its servos, activation filter,
``prev_v`` and force/torque obs go through it.  Walk and escape differ
in their start, obs and reward: those run from JAX's draws and states
against JAX's own functions (fetch in ``test_torch_mujoco_dmc_fetch.py``).
"""

import dataclasses
import pathlib
import sys

import pytest
import torch

import envpool_tpu_torch
from envpool_tpu_torch.core.engine import Engine, _tree_map
from test_torch_mujoco_dmc_suite2 import check_start_obs_and_reward, check_stiff_step


def test_quadruped_run_step_matches_jax_across_auto_reset():
    check_stiff_step("QuadrupedRun-v1")


@pytest.mark.parametrize("task", ["QuadrupedWalk-v1", "QuadrupedEscape-v1"])
def test_start_obs_and_reward_match_jax(task):
    check_start_obs_and_reward(task)


# -- the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_quadruped_card_step_matches_cpu():
    """QuadrupedRun-v1 at 1024 envs: the card's engine step from the card's
    state after 20 random steps, against the CPU's from the same state and
    action.  Every env whose substeps do not cross a penalty-force switch
    differently on the two devices (``dynamics.switch_sides``, at most 1%)
    agrees within 1e-4 · (1 + |cpu|) in its state, and in its reward and
    done, which the CPU computes from the card's new state.  Its obs, held
    as one block, pass past that bar by ``chip_smoke.py``'s spread rule
    alone (the toes' force obs, arcsinh of 2e4 times a depth, scales a
    depth's rounding 2e4-fold): where the card lies within max(1e-4,
    ``SPREAD_FACTOR`` times ``float32_spread``) of the float64 obs of that
    state, in at most 1% of the envs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from envpool_tpu_torch.physics import dynamics

    n, tol = 1024, 1e-4
    card = envpool_tpu_torch.make_spec("QuadrupedRun-v1", num_envs=n, seed=5).env
    cpu = envpool_tpu_torch.make_spec("QuadrupedRun-v1", num_envs=n, seed=5, device="cpu").env
    ceng, teng = Engine(card), Engine(cpu)
    ps = ceng.init()
    gen = torch.Generator().manual_seed(5)

    def act():
        return torch.rand(n, card.model.nu, generator=gen) * 2 - 1

    for _ in range(20):
        ps, _ = ceng.step(ps, {"action": act().cuda()})
    a = act()
    hps = type(ps)(*(_tree_map(lambda x: x.cpu(), f) for f in (
        ps.env_state, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)))
    ps_card, got = ceng.step(ps, {"action": a.cuda()})
    st = hps.env_state
    ctrl = cpu.control(st, a)
    q, qd = st["qpos"], st["qvel"]
    cq, cqd = q.cuda(), qd.cuda()
    crossed = torch.zeros(n, dtype=torch.bool)
    # one substep at a time: a model whose timestep is the substep's
    sub = dataclasses.replace(cpu.model, timestep=cpu.model.timestep / cpu.substeps)
    for _ in range(card.frame_skip * card.substeps):
        q, qd = dynamics.step(sub, q, qd, ctrl, 1, cpu.contact)
        cq, cqd = dynamics.step(sub, cq, cqd, ctrl.cuda(), 1, card.contact)
        crossed |= (dynamics.switch_sides(sub, cq, card.contact).cpu()
                    != dynamics.switch_sides(sub, q, cpu.contact)).any(1)
    keep = ~(crossed | hps.autoreset)
    assert int(crossed.sum()) <= n // 100
    rel = chip_smoke._rel
    new = {k: ps_card.env_state[k].cpu() for k in ("qpos", "qvel")}
    for k, w in (("qpos", q), ("qvel", qd)):
        assert float(rel(new[k], w)[keep].max()) <= tol, k
    # obs, reward and done of the card's new state, computed by the CPU
    cpu.physics_step = lambda *args, **kwargs: (new["qpos"], new["qvel"])
    _, want = teng.step(hps, {"action": a})
    new_state = cpu.next_state(st, a, new["qpos"], new["qvel"])
    obs_keys = list(cpu.obs_fields(new_state))

    def flat_obs(s):
        fields = cpu.obs_fields(s)
        return torch.cat([fields[k].reshape(s["qpos"].shape[0], -1) for k in obs_keys], 1)

    for k, w in want.items():
        g = got[k].cpu()
        if k in obs_keys:
            continue
        if not w.is_floating_point():
            assert torch.equal(g[keep], w[keep]), k
        else:
            assert float(rel(g.reshape(n, -1), w.reshape(n, -1))[keep].max()) <= tol, k
    g, w = (torch.cat([x[k].cpu().reshape(n, -1) for k in obs_keys], 1) for x in (got, want))
    idx = ((rel(g, w) > tol) & keep).nonzero()[:, 0]
    assert len(idx) <= n // 100
    if len(idx):
        rows = chip_smoke._rows(new_state, idx)
        ref = flat_obs(chip_smoke._float64(rows, "cpu"))
        spread = chip_smoke.float32_spread(
            lambda q, qd: flat_obs(dict(rows, qpos=q, qvel=qd)), (rows["qpos"], rows["qvel"]), ref)
        limit = torch.clamp(chip_smoke.SPREAD_FACTOR * spread, min=tol)
        assert bool((rel(g[idx], ref) <= limit).all())
