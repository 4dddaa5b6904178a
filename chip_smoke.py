#!/usr/bin/env python3
"""Smoke test of envpool_tpu_torch on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernel (K1: fused max-pool + INTER_AREA resize,
``envpool_tpu_torch/csrc/pool_resize.cu``), holds it against its plain
PyTorch version on the card, drives PongLite-v5 at 2048 envs through the
gymnasium, dm and functional entry points, checks the card against the
CPU port, profiles one engine step, and times a rollout.  It exits non-zero on any failure, and
when no CUDA device is present.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the ``kernels`` JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20260
N_ENVS = 2048
RAW_HW = (210, 160)
OUT_HW = (84, 84)
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TIE_RULE = "equal everywhere except exact .5 ties, where |diff| <= 1"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pong_frames(n: int, device, rgb: bool):
    """Two consecutive Pong frames of ``n`` random mid-rally states."""
    import torch

    from envpool_tpu_torch.envs.atari.pong import PongGame

    game = PongGame(torch.device(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)

    def uniform(lo, hi):
        u = torch.rand(n, generator=gen, device=device)
        return torch.floor(lo + (hi - lo) * u * 4) / 4

    g = game.init(torch.zeros(n, dtype=torch.int32, device=device))
    g.update(
        ball_x=uniform(0, 158),
        ball_y=uniform(34, 192),
        player_y=uniform(34, 178),
        cpu_y=uniform(34, 178),
        serve_timer=torch.zeros(n, dtype=torch.int32, device=device),
    )
    actions = torch.randint(0, 6, (n,), generator=gen, device=device)
    g2 = game.tick(g, actions.to(torch.int32), torch.zeros_like(actions))[0]
    render = game.render_rgb if rgb else game.render_gray
    f0, f1 = render(g), render(g2)
    if rgb:  # fold the channels into the batch, as the env does
        return torch.stack([f0, f1], 2).reshape(n * 3, 2, *RAW_HW)
    return torch.stack([f0, f1], 1)


def phase_kernel_vs_plain(device: str, n: int) -> dict:
    """K1 against its plain version on random, Pong and RGB-Pong frames."""
    import torch

    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.image import (
        area_bands,
        area_ties,
        pool_resize,
        resize_matrices,
        tie_rule_violations,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    inputs = {
        "random_int": torch.randint(
            0, 256, (n, 2, *RAW_HW), generator=gen, device=device
        ).to(torch.float32),
        "pong_gray": _pong_frames(n, device, rgb=False),
        "pong_rgb": _pong_frames(n, device, rgb=True),
    }
    max_err = 0
    for name, frames in inputs.items():
        got = fused_pool_resize(frames, OUT_HW)
        ref = pool_resize(frames, OUT_HW)
        ties = area_ties(frames[:, 0], frames[:, 1], OUT_HW)
        bad, at_ties = tie_rule_violations(got, ref, ties)
        err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        max_err = max(max_err, err)
        print(
            f"K1 vs plain [{name} {tuple(frames.shape)}]: violations={bad} "
            f"tie_mismatches={at_ties} ties={int(ties.sum())} "
            f"max_abs_err={err} ({TIE_RULE})"
        )
        _check(bad == 0, f"K1 disagrees with its plain version on {name}")

    frames = inputs["random_int"]
    wh, ww = resize_matrices(RAW_HW, OUT_HW, device)
    pooled = torch.maximum(frames[:, 0], frames[:, 1])
    k1_ms = _time_ms(lambda: fused_pool_resize(frames, OUT_HW))
    plain_ms = _time_ms(lambda: pool_resize(frames, OUT_HW))
    lib_ms = _time_ms(lambda: torch.matmul(torch.matmul(wh, pooled), ww))
    (H, W), (h, w) = RAW_HW, OUT_HW
    nbytes = n * (2 * H * W * 4 + h * w)
    _, rc, _ = area_bands(H, h)
    _, cc, _ = area_bands(W, w)
    # max of the two frames, then per pixel rc*cc row FMAs + cc column FMAs
    fmas = int((np.outer(rc, cc) + cc[None, :]).sum())
    flops = n * (H * W + 2 * fmas)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"K1 timing at {tuple(frames.shape)}: K1 {k1_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.matmul(Wh, pooled) @ Ww {lib_ms:.4f} ms"
    )
    print(
        f"K1 bound: {nbytes / 1e6:.1f} MB / 3.35 TB/s = {bytes_ms:.4f} ms; "
        f"{flops / 1e9:.3f} GFLOP / 67 TFLOP/s = {ops_ms:.4f} ms"
    )
    return {
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": lib_ms,
    }


def phase_adapters(device: str, n: int) -> None:
    """PongLite-v5 through the gymnasium, dm and truncating pools."""
    import torch

    import envpool_tpu_torch

    env = envpool_tpu_torch.make(
        "PongLite-v5", env_type="gymnasium", num_envs=n, seed=SEED,
        device=device, numpy_output=False,
    )
    obs, info = env.reset()
    rng = np.random.default_rng(SEED)
    rewards = []
    for _ in range(64):
        act = torch.as_tensor(rng.integers(0, 6, n, dtype=np.int32))
        obs, rew, term, trunc, info = env.step(act)
        rewards.append(rew)
    rew = torch.stack(rewards)
    _check(tuple(obs.shape) == (n, 4, *OUT_HW), f"obs shape {tuple(obs.shape)}")
    _check(obs.dtype == torch.uint8, f"obs dtype {obs.dtype}")
    _check(obs.device.type == torch.device(device).type, f"obs on {obs.device}")
    _check(bool(torch.isin(rew, torch.tensor([-1.0, 0.0, 1.0], device=rew.device)).all()),
           "rewards outside {-1, 0, 1}")
    print(
        f"gymnasium: obs {tuple(obs.shape)} {obs.dtype} on {obs.device}; "
        f"64 steps, points won {int((rew > 0).sum())}, lost {int((rew < 0).sum())}"
    )

    dm = envpool_tpu_torch.make_dm(
        "PongLite-v5", num_envs=n, seed=SEED, device=device
    )
    ts = dm.reset()
    _check(bool((ts.step_type == 0).all()), "dm reset step_type")
    for _ in range(4):
        ts = dm.step(rng.integers(0, 6, n, dtype=np.int32))
    _check(bool((ts.step_type == 1).all()), "dm step_type")
    _check(ts.observation.obs.shape == (n, 4, *OUT_HW), "dm obs shape")
    print(f"dm: 4 steps, obs {ts.observation.obs.shape}, step_type {set(ts.step_type.tolist())}")

    short = envpool_tpu_torch.make(
        "PongLite-v5", env_type="gymnasium", num_envs=n, seed=SEED,
        device=device, max_episode_steps=40,
    )
    short.reset()
    for t in range(1, 42):
        obs, rew, term, trunc, info = short.step(np.zeros(n, np.int32))
        if t == 40:
            _check(bool(trunc.all()), "no truncation at max_episode_steps")
            _check(int(info["elapsed_step"].min()) == 40, "elapsed at truncation")
    _check(int(info["elapsed_step"].max()) == 0, "auto-reset after truncation")
    print("truncation at 40 steps and auto-reset: ok")


def phase_card_vs_cpu(device: str, n: int, steps: int) -> None:
    """The same seed on the card and on the CPU: game state, reward, done
    identical; obs equal except at exact .5 ties."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.envs.atari.obs_ties import ObsTies
    from envpool_tpu_torch.ops.image import tie_rule_violations

    pools = {
        d: envpool_tpu_torch.make(
            "PongLite-v5", env_type="gymnasium", num_envs=n, seed=SEED,
            device=d, max_episode_steps=150,
        )
        for d in (device, "cpu")
    }
    ties = ObsTies(pools["cpu"].spec.env)
    outs = {d: p.reset()[0] for d, p in pools.items()}
    mask = ties.after_reset()
    rng = np.random.default_rng(SEED)
    tie_diffs = 0
    for t in range(steps + 1):
        if t:
            act = rng.integers(0, 6, n, dtype=np.int32)
            outs = {d: p.step(act) for d, p in pools.items()}
            a, b = outs[device], outs["cpu"]
            for i, name in ((1, "reward"), (2, "terminated"), (3, "truncated")):
                _check(np.array_equal(a[i], b[i]), f"{name} differs at step {t}")
            mask = ties.after_step(torch.as_tensor(b[4]["elapsed_step"] == 0))
        ga = pools[device].pool_state.env_state["game"]
        gb = pools["cpu"].pool_state.env_state["game"]
        for k in gb:
            _check(torch.equal(ga[k].cpu(), gb[k]), f"game[{k}] differs at step {t}")
        oa = torch.as_tensor(outs[device][0] if t else outs[device])
        ob = torch.as_tensor(outs["cpu"][0] if t else outs["cpu"])
        bad, at_ties = tie_rule_violations(oa, ob, mask)
        _check(bad == 0, f"obs differ outside ties at step {t}")
        tie_diffs += at_ties
    print(
        f"card vs CPU, {n} envs x {steps} steps: game state, reward, done "
        f"identical; obs tie mismatches {tie_diffs} ({TIE_RULE})"
    )


def phase_throughput(device: str, n: int, steps: int) -> tuple[float, float]:
    """Functional rollout as ``bench.py`` runs it (reset, then ``steps``
    random steps); returns (env-steps/s, K1 launches per env step)."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize

    pool = envpool_tpu_torch.make(
        "PongLite-v5", env_type="gymnasium", num_envs=n, seed=SEED,
        device=device, numpy_output=False,
    )

    def policy(ts, gen):
        return {"action": torch.randint(
            0, 6, (n,), generator=gen, device=device, dtype=torch.int32)}

    run = pool.engine.make_rollout(policy, steps, collect=False)
    ps, _ = run(pool.pool_state, SEED)  # warm-up
    torch.cuda.synchronize()
    before = fused_pool_resize.launches
    t0 = time.perf_counter()
    ps, ts = run(ps, SEED + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # one launch for the reset, then one per branch of every step
    per_step = (fused_pool_resize.launches - before - 1) / steps
    _check(bool((ts["step_type"] >= 0).all()), "rollout output")
    return steps * n / dt, per_step


def phase_profile(device: str, n: int, steps: int) -> None:
    """``torch.profiler`` over ``steps`` engine steps: device time, idle
    share, launches per step and the kernels that take the most time."""
    import torch

    import envpool_tpu_torch

    pool = envpool_tpu_torch.make(
        "PongLite-v5", env_type="gymnasium", num_envs=n, seed=SEED,
        device=device, numpy_output=False,
    )
    eng = pool.engine
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def act():
        return {"action": torch.randint(
            0, 6, (n,), generator=gen, device=device, dtype=torch.int32)}

    ps, _ = eng.reset(pool.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(4):
        ps, _ = eng.step(ps, act())
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ps, _ = eng.step(ps, act())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    _check(device_us > 0, "the profiler saw no device time")
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    print(
        f"profile, engine.step at {n} envs x {steps} steps: wall {wall / steps * 1e3:.3f} "
        f"ms/step under the profiler, device {device_us / steps / 1e3:.3f} ms/step, "
        f"idle share {1 - device_us / 1e6 / wall:.3f}, {launches / steps:.0f} "
        "kernel launches/step; top kernels (ms/step, launches/step):"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.4f} "
              f"{e.count / steps:6.0f}  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import envpool_tpu_torch  # noqa: F401  (fails outside the repository)
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize

    t_start = time.perf_counter()
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"K1 build: {fused_pool_resize.build():.1f} s")
    stats = phase_kernel_vs_plain(device, N_ENVS)

    fused_pool_resize.launches = 0
    phase_adapters(device, N_ENVS)
    launches = fused_pool_resize.launches
    _check(launches > 0, "the main path never launched K1")
    print(f"K1 launches on the main path: {launches}")

    phase_card_vs_cpu(device, 8, 200)
    phase_profile(device, N_ENVS, 16)
    steps_per_s, per_step = phase_throughput(device, N_ENVS, 256)
    _check(per_step == 2, f"K1 launches per env step {per_step}, expected 2")
    print(f"K1 launches per env step: {per_step:g} (step branch + reset branch)")
    print(
        f"PongLite-v5 functional rollout, {N_ENVS} envs x 256 steps: "
        f"{steps_per_s:,.0f} env-steps/s = {steps_per_s * 4:,.0f} frames/s "
        f"(frame_skip 4) on {smi}"
    )
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "K1",
        "route": "cuda",
        "source": "envpool_tpu_torch/csrc/pool_resize.cu",
        "replaces": "envpool_tpu/ops/pallas_image.py:33",
        "launches": launches,
        **stats,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
