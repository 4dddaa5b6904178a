#!/usr/bin/env python3
"""Smoke test of envpool_tpu_torch on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's three CUDA kernels at once (K1: fused max-pool +
INTER_AREA resize, ``envpool_tpu_torch/csrc/pool_resize.cu``; K2: one video
frame of every 2600 machine, ``envpool_tpu_torch/csrc/machine_frame.cu``;
PGS: the constraint solver after its rows, the active block of
``A = J M^-1 J^T``, the projected Gauss-Seidel sweeps and ``J^T f``,
``envpool_tpu_torch/csrc/pgs_solve.cu``) and holds each against its plain
PyTorch version on the card.  Then, for
PongLite-v5 at 2048 envs, Machine2600-v0 (the 6502+TIA emulator on the
repository's hand-built pong cart) at 1024 envs, CartPole-v1 at 16384 envs
and HalfCheetah-v4, Ant-v4 and Humanoid-v4 (the rigid-body physics, the
last two with a free base) at 8192 envs, it drives the gymnasium, dm and
functional entry points, checks the card against the CPU port, profiles
engine steps and times a rollout; so too for the dm_control suite's
CheetahRun-v1 at 4096 envs, whose resets must match the CPU's bit for bit,
and QuadrupedRun-v1 at 4096 envs (affine-bias servos on tendon
transmissions), whose resets must match the CPU's drop heights; so too
for toy_text's FrozenLake8x8-v1 at 16384 envs (card and CPU equal in every
field) and the dog's DogRun-v1 at 4096 envs (79 dofs stepped in float64;
its card-vs-CPU phase at 128 envs).  Every other toy_text id and Dummy-v0
(one and two players) get an exact card-vs-CPU check at 256 envs, every
other Gym-MuJoCo id a short card-vs-CPU check at 256 envs (1024 with
a free base), every other dm_control id one at 256 envs (among them
the limited spatial tendon of ball_in_cup and the body-body contact pairs
of finger, quadruped fetch, manipulator and stacker), and the other four
Dog ids one at 32 envs.  Then Ant-v4 with ``contact_solver="mujoco"`` at
8192 envs (the PGS kernel's path; card vs CPU at 1024), CheetahRun-v1 and
SwimmerSwimmer15-v1 in solver mode at 256, CheetahRun-v1 ``from_pixels``
at 4096 envs (its frames card vs CPU by the frame rule), procgen's
MazeEasy-v0 at 2048 envs (card and CPU equal in every field) and
vizdoom's Basic-v1 at 1024 envs (card vs CPU by the rule of
``envpool_tpu_torch/ops/thresholds.py``), each through every entry point,
profiled (the reset branch alone too) and timed, with every other procgen
grid id an exact check at 256 envs and every other procgen and vizdoom id
a check by the rule at 64 envs, minigrid's MiniGrid-Empty-8x8-v0 and
BabyAI-BossLevel-v0 at 8192 envs (every other minigrid id exact at 64),
the board games' TicTacToe-v1 and Go19x19-v1 at 8192 envs (card vs CPU
equal in every field, by legal moves; every other board id exact at 64
across a reset), highway's Highway-v0 and Intersection-v0 at 2048 envs
(card vs CPU by the rule at 256; every other highway id by the rule at
64 across a reset), robotics' FetchPickAndPlace-v4 and HandReach-v3 and
MetaWorld/PickPlace-v3 at 8192 envs (card vs CPU by the rule at 256; the
other 155 robotics ids and 49 MetaWorld ids by the rule at 64 across a
reset), and the engine's remaining surface on the card:
``render()``, ``save_state`` / ``load_state``, ``record_dir`` and two
wrappers.  The CPU's side of the physics short checks runs in a worker
process while the card goes on with the next id, and the main paths'
card-vs-CPU phases run at ``N_MAIN_VS`` envs (CartPole-v1 at its full
width); neither changes a check's rule.  Each timed rollout follows a
warm-up of ``WARMUP_ROLLOUT`` steps at its shapes, and prints its depth;
each profile holds one engine step, with the profiler's CUDA activity
alone.  It also times K2
alone at 1024 and 4096 machines (frames/s, emulated 6502 cycles/s) and
holds it to its chain bound: each frame's most emulated instructions on
one machine times one dependent shared-memory load, measured on the card.
It exits non-zero on any failure, and when no CUDA device is present.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the ``kernels`` JSON record.
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20260
N_ENVS = 2048
N_MACHINES = 1024  # the width bench.py:147 used for the emulator
RAW_HW = (210, 160)
OUT_HW = (84, 84)
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TIE_RULE = "equal everywhere except exact .5 ties, where |diff| <= 1"
# The widths bench.py runs them at (bench.py:133, :103, :120); Humanoid-v4
# at Ant's width.
N_CARTPOLE = 16384
N_CHEETAH = 8192
N_ANT = N_HUMANOID = 8192
# The physics main paths' card-vs-CPU phases run at N_MAIN_VS envs (the
# first envs of the same seeds): with 3 checked steps each share that
# check_shares reads comes from 3072 env steps, N_SHORT_FREE's reasoning.
# Their adapters, profiles and rollouts stay at full width.  CartPole-v1
# keeps its 16384 envs: its intermittent card-vs-CPU failure was seen at
# that width (ROADMAP Queue 3).
N_MAIN_VS = 1024
# The short card-vs-CPU check of the other Gym-MuJoCo ids: 256 envs, and
# 1024 for those with a free base, whose float32 steps most often land past
# the tolerance (so that each id's share is read from 3072 env steps).
N_SHORT = 256
N_SHORT_FREE = 1024
FREE_BASE = ("Ant", "Humanoid", "HumanoidStandup")
# The tasks whose float32 step itself lands past PHYSICS_TOL of a float64
# step on some states, on the card and on the CPU alike (PERF.md, section
# 6): there an env past the tolerance may pass where the card lies within
# SPREAD_FACTOR times float32's own spread on the CPU (float32_spread) of
# float64.  Every other task is held to the strict rule
# (phase_float_card_vs_cpu).
SPREAD = FREE_BASE + ("Hopper", "Walker2d")
SPREAD_MOVES = 16
SPREAD_FACTOR = 4.0
# One step from the same state, |card - cpu| <= tol * (1 + |cpu|): float32
# rounding for CartPole (tests/test_torch_classic.py), 1e-4 for the
# physics (tests/test_torch_physics.py).
CARTPOLE_TOL = 2e-6
PHYSICS_TOL = 1e-4
# dm_control: CheetahRun-v1, QuadrupedRun-v1 and DogRun-v1 at the width of
# bench.py's sweep row (bench.py:201); the other 44 ids a short check at
# N_SHORT envs.  DogRun-v1's card-vs-CPU phase runs at N_DOG_VS envs and
# the other four Dog ids' at N_DOG_SHORT: the CPU's side of 4096 dogs (79
# dofs, 6 float64 substeps per step) would not fit the script's time.
N_DMC = 4096
N_DOG_VS = 128
N_DOG_SHORT = 32
# toy_text: FrozenLake8x8-v1 at the width of bench.py's sweep row
# (bench.py:198); every other toy_text id and Dummy-v0 an exact short check
# at N_EXACT envs.
N_FROZEN = 16384
N_EXACT = 256
# The dm_control ids held to the SPREAD rule: humanoid_CMU's float32 step
# lands past PHYSICS_TOL of float64 on some states on either device, and
# QuadrupedRun-v1's toe-force obs (arcsinh of 2e4 times a depth, which
# scales a depth's rounding 2e4-fold) did so at N_DMC envs under the strict
# rule, as every Dog id's touch and foot-force obs (2e4 times a depth) did
# (DogRun-v1 at 256 envs, the others at 64; PERF.md, section 6); the other
# ids pass the strict rule.
DMC_SPREAD = ("HumanoidCMUStand-v1", "HumanoidCMUWalk-v1", "HumanoidCMURun-v1",
              "QuadrupedRun-v1", "DogStand-v1", "DogWalk-v1", "DogTrot-v1", "DogRun-v1",
              "DogFetch-v1")
# The classes whose reference physics diverges on some start states, on
# every device (a 1e-6 kg body under explicit pair springs at kp 1e4): an
# env whose state leaves the finite numbers on both devices alike is left
# out of their card-vs-CPU check, in at most DIVERGE_SHARE of the env steps
# (~16% measured, PERF.md, section 6).  Any other id fails on a state that
# is not finite.
DIVERGING_CLASSES = ("ManipulatorEnv", "StackerEnv")
DIVERGE_SHARE = 0.25


# The constraint solver's main path: Ant-v4 at N_ANT envs (bench.py:120),
# its card-vs-CPU phase at N_SOLVER_VS (the CPU runs the plain sweeps, a
# Python loop over the rows), a rollout of SOLVER_ROLLOUT steps, and short
# checks of SOLVER_SHORT in solver mode (SwimmerSwimmer15-v1 steps in
# float64: the kernel's double instance on a path).
N_SOLVER_VS = 1024
SOLVER_ROLLOUT = 32
SOLVER_SHORT = ("CheetahRun-v1", "SwimmerSwimmer15-v1")
# from_pixels: CheetahRun-v1 at N_DMC envs, 84x84, 3 frames; a rollout of
# PIXEL_ROLLOUT steps.  Frames card vs CPU by the frame rule, at most
# MAX_PIXEL_DIFFER of the pixels differing (tests/test_torch_pixels.py).
PIXEL_ROLLOUT = 32
MAX_PIXEL_DIFFER = 1e-3


# The script's time limit is fixed while it grows: the short checks of the
# earlier slices' ids take fewer checked steps than the newest ids' 3
# (Gym-MuJoCo's 1, the dm_control ids of the first two slices 2), the
# Gym-MuJoCo ids after 20 warm-up steps, not 30, and the main paths'
# profiles take 1 step, not 4, with the profiler's CUDA activity alone
# (the kernels and the runtime's launch calls; its CPU activity, an event
# per operator, took most of a profile's time in collecting its events;
# PERF.md, section 5).
SHORT_STEPS = {"gym": 1, "dmc": 2}
SHORT_WARMUP_GYM = 20
PROFILE_STEPS = 1
PROFILE_RESETS = 3


def host_cpu() -> str:
    """What tells one host from another (its name, the card's UUID, the
    CPU's count, ATen's CPU vector unit, a hash of the CPU's flags), and how
    far the CPU's float32 ``sin`` and ``cos`` land from float64 over the
    angles CartPole visits (the CPU port is the card's reference in the
    card-vs-CPU phases)."""
    import hashlib
    import os
    import platform

    import torch

    from envpool_tpu_torch.tools.k2_probe import smi

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line.partition(":")[2].strip() for line in f
                          if line.split(":")[0].strip() in ("flags", "Features")), "")
    except OSError:
        pass
    x = torch.linspace(-0.3, 0.3, 65536).reshape(-1, 4)[:, 2]  # strided, as CartPole's
    errs = [float((fn(x).double() - fn(x.double())).abs().max())
            for fn in (torch.sin, torch.cos)]
    return (f"host: {platform.node()}, card {smi('uuid')}; CPU {platform.machine()} x "
            f"{os.cpu_count()}, ATen {torch.backends.cpu.get_cpu_capability()}, flags "
            f"{hashlib.sha1(flags.encode()).hexdigest()[:12]} ({len(flags.split())}), "
            f"{torch.get_num_threads()} threads; its float32 sin, cos within "
            f"{errs[0]:.3g}, {errs[1]:.3g} of float64 on [-0.3, 0.3]")


def say(line: str) -> None:
    """One line to stdout in one write (the CPU's worker process writes
    there too)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


# The results of one family's short checks in CpuSide's worker process, for
# family_checks.
_FAMILY_RESULTS: dict = {}


def _cpu_worker(threads: int) -> None:
    """The worker process's start: the main process's count of CPU threads,
    so that the CPU's float32 reductions split as they would there, and
    its settings of the card (no TF32)."""
    import torch

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.allow_tf32 = False


class CpuSide:
    """One worker process for the CPU's side of the physics short checks
    and its float64 arbitration (:func:`cpu_side`, from
    :func:`phase_float_card_vs_cpu` with ``later``: the CPU's steps, and
    the card's float64 step and substeps, in a CUDA context of its own),
    which runs while the main process goes on with the card's work: the
    checks, their rules, their inputs and the order of their ``_check``
    calls stay as they are; only when and where they are computed changes.
    (A thread would share the GIL with the card's launches, which are
    host-bound: both slowed down.)  Jobs run one at a time in the
    order they were submitted and write their lines as they run.
    :meth:`poll` re-raises the first failure of a finished job, :meth:`drain`
    waits for every job and re-raises the first failure, with its own
    message; leaving its ``with`` block stops the worker (and drops the
    jobs not yet begun)."""

    def __init__(self):
        import multiprocessing

        import torch

        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_worker,
            initargs=(torch.get_num_threads(),))
        self.jobs: list = []

    def submit(self, fn, *args, **kwargs):
        job = self.pool.submit(fn, *args, **kwargs)
        self.jobs.append(job)
        return job

    def poll(self) -> None:
        for job in self.jobs:
            if job.done() and job.exception() is not None:
                raise job.exception()

    def drain(self) -> float:
        """Wait for every job; returns the seconds waited."""
        t0 = time.perf_counter()
        for job in self.jobs:
            job.result()
        return time.perf_counter() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.pool.shutdown(cancel_futures=True)


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


def _sampler(spec, n: int, device, players: int = 1):
    """``sample(gen)``: random actions of an action spec for ``n`` envs on
    ``device`` (one row per player of a per-player spec), integers over a
    discrete spec's range, else floats uniform within its bounds."""
    import torch

    shape = (n, *spec.static_shape(players))
    if spec.is_discrete:
        lo, hi = int(spec.minimum), int(spec.maximum) + 1
        return lambda gen: torch.randint(
            lo, hi, shape, generator=gen, device=device, dtype=torch.int32)
    lo, hi = (torch.as_tensor(np.asarray(b, np.float32), device=device)
              for b in (spec.minimum, spec.maximum))
    return lambda gen: lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _spec(pool):
    return pool.spec.action_array_spec["action"]


# The board games' legal-move masks; a share of uniform actions stays in
# the board ids' sampling, so that the illegal-move path runs too.
LEGAL_KEYS = ("info:legal_moves", "info:legal_action_mask")
LEGAL_UNIFORM_SHARE = 0.05


def _legal_sampler(spec, n: int, device, players: int = 1):
    """``sample(gen, ts)``: actions uniform over each env's legal moves in
    the timestep ``ts`` (its ``LEGAL_KEYS`` mask), drawn from the same
    ``torch.Generator`` as :func:`_sampler`'s, a share
    ``LEGAL_UNIFORM_SHARE`` of them uniform over the action space; uniform
    before the first timestep or where the game has no mask.  Under the
    per-player protocol every player's row holds the action (the games read
    the mover's row, or row 0)."""
    import torch

    uniform = _sampler(spec, n, device, players)

    def sample(gen, ts=None):
        act = uniform(gen)
        mask = next((ts[k] for k in LEGAL_KEYS if k in ts), None) if ts is not None else None
        if mask is None:
            return act
        mask = mask.to(device)
        score = torch.where(mask, torch.rand(mask.shape, generator=gen, device=device), -1.0)
        legal = score.argmax(1).to(act.dtype)
        share = torch.rand(n, generator=gen, device=device) < LEGAL_UNIFORM_SHARE
        pick = torch.where(share, act.reshape(n, -1)[:, 0], legal)
        return pick if act.dim() == 1 else pick[:, None].expand_as(act).contiguous()

    return sample


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


def phase_card_vs_cpu(device: str, task: str, n: int, steps: int,
                      hold: int | None = None, **make_kwargs) -> None:
    """An Atari task with the same seed on the card and on the CPU: game
    state, reward, done identical; obs equal except at exact .5 ties.  With
    ``hold``, env 0 takes that action every step and the run must see a
    termination."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.envs.atari.obs_ties import ObsTies
    from envpool_tpu_torch.ops.image import tie_rule_violations

    pools = {
        d: envpool_tpu_torch.make(
            task, env_type="gymnasium", num_envs=n, seed=SEED, device=d,
            **make_kwargs,
        )
        for d in (device, "cpu")
    }
    ties = ObsTies(pools["cpu"].spec.env)
    outs = {d: p.reset()[0] for d, p in pools.items()}
    mask = ties.after_reset()
    sample = _sampler(_spec(pools["cpu"]), n, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    tie_diffs, terms = 0, 0
    for t in range(steps + 1):
        if t:
            act = sample(gen)
            if hold is not None:
                act[0] = hold
            outs = {d: p.step(act) for d, p in pools.items()}
            a, b = outs[device], outs["cpu"]
            for i, name in ((1, "reward"), (2, "terminated"), (3, "truncated")):
                _check(np.array_equal(a[i], b[i]), f"{name} differs at step {t}")
            terms += int(b[2].sum())
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
    _check(hold is None or terms > 0, "no termination in the card vs CPU run")
    print(
        f"{task} card vs CPU, {n} envs x {steps} steps: game state, reward, "
        f"done identical ({terms} terminations); obs tie mismatches "
        f"{tie_diffs} ({TIE_RULE})"
    )


def _pool(device: str, task: str, n: int, **make_kwargs):
    import envpool_tpu_torch

    return envpool_tpu_torch.make(
        task, env_type="gymnasium", num_envs=n, seed=SEED, device=device,
        numpy_output=False, **make_kwargs,
    )


# The warm-up rollout before each timed one: steps at the timed run's
# shapes (every kernel of the step, the allocator's blocks), not its depth.
WARMUP_ROLLOUT = 2


def phase_throughput(device: str, task: str, n: int, steps: int, depth: int = 0,
                     legal: bool = False, **make_kwargs) -> tuple[float, int]:
    """Functional rollout as ``bench.py`` runs it (reset, then ``steps``
    random steps, by legal moves with ``legal``; with ``depth``, ``depth +
    steps`` steps timed from the ``depth``-th on), after a warm-up rollout
    of ``WARMUP_ROLLOUT`` steps at the same shapes; returns (env-steps/s,
    K1 launches in the timed run)."""
    import torch

    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize

    pool = _pool(device, task, n, **make_kwargs)
    draw = _legal_sampler(_spec(pool), n, device) if legal else _sampler(_spec(pool), n, device)
    calls, t0 = [0], [0.0]

    def policy(ts, gen):
        if depth and calls[0] == depth:  # the timed steps begin
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()
        calls[0] += 1
        return {"action": draw(gen, ts) if legal else draw(gen)}

    warm = pool.engine.make_rollout(policy, WARMUP_ROLLOUT, collect=False)
    ps, _ = warm(pool.pool_state, SEED)
    run = pool.engine.make_rollout(policy, depth + steps, collect=False)
    torch.cuda.synchronize()
    calls[0] = 0
    before = fused_pool_resize.launches
    t0[0] = time.perf_counter()
    ps, ts = run(ps, SEED + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0[0]
    _check(bool((ts["step_type"] >= 0).all()), "rollout output")
    for k, v in ts.items():
        if k == "obs" or k.startswith("obs:"):
            _check(not v.is_floating_point() or bool(torch.isfinite(v).all()),
                   f"rollout {k} not finite")
    return steps * n / dt, fused_pool_resize.launches - before


def _device_events(events) -> list:
    """The profiler's device-side events (kernels, copies).  The host-side
    op events carry the same device time again, so only these are summed."""
    import torch

    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def _launches(events) -> int:
    """Kernel launches the profiler saw on the host side."""
    return sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))


def phase_profile(device: str, task: str, n: int, steps: int, warmup: int,
                  kernel: str | None = None, legal: bool = False, **make_kwargs) -> dict:
    """``torch.profiler`` over ``steps`` engine steps after ``warmup`` ones
    (by legal moves with ``legal``, the sampler's launches among the
    step's): device time, idle share, launches per step, the kernels that
    take the most time and, given a kernel's name, its share of the device
    time.  The device ms and the idle share stand only where the profiler
    kept a device record for every kernel launched (late in a long process
    it drops some); else both are None, and ``said`` tells it with the
    count and the bounds the kept records give.  Returns the first three, ``said`` and the last pool state
    (``ps``)."""
    import torch

    pool = _pool(device, task, n, **make_kwargs)
    eng = pool.engine
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    draw = _legal_sampler(_spec(pool), n, device) if legal else _sampler(_spec(pool), n, device)

    def act(ts):
        return {"action": draw(gen, ts) if legal else draw(gen)}

    ps, ts = eng.reset(pool.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(warmup):
        ps, ts = eng.step(ps, act(ts))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ps, ts = eng.step(ps, act(ts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = _device_events(events)
    device_us = sum(e.self_device_time_total for e in kernels)
    _check(device_us > 0, "the profiler saw no device time")
    launches = _launches(events)
    _check(launches > 0, "the profiler saw no kernel launch")
    kept = sum(e.count for e in kernels if not e.key.startswith(("Memcpy", "Memset")))
    measured = kept >= launches
    device_ms = device_us / steps / 1e3 if measured else None
    idle = 1 - device_us / 1e6 / wall if measured else None
    said = (f"{device_ms:.3f} device ms, idle share {idle:.3f}" if measured else
            f"device ms and idle share not measured (the profiler kept {kept} of {launches} "
            f"kernels: at least {device_us / steps / 1e3:.3f} device ms, an idle share of at "
            f"most {1 - device_us / 1e6 / wall:.3f})")
    share = ""
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.key]
        _check(bool(mine), f"the profiler saw no {kernel} launch")
        mine_us = sum(e.self_device_time_total for e in mine)
        share = (f"{kernel} {mine_us / steps / 1e3:.3f} ms/step over "
                 f"{sum(e.count for e in mine) / steps:g} launches/step = "
                 f"{mine_us / device_us:.3f} of device time; ")
    print(
        f"profile, {task} engine.step at {n} envs x {steps} steps: wall "
        f"{wall / steps * 1e3:.3f} ms/step under the profiler, device records "
        f"{kept} of {launches} kernels launched: {said} per step, "
        f"{launches / steps:.0f} kernel launches/step; {share}top kernels (ms/step, "
        f"launches/step):"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.4f} "
              f"{e.count / steps:6.0f}  {e.key[:90]}")
    return {"device_ms": device_ms, "idle": idle, "said": said,
            "launches": launches / steps, "ps": ps}


# ---------------------------------------------------------------------------
# Machine2600 (the 6502+TIA emulator) and K2
# ---------------------------------------------------------------------------


def _k2_vs_plain(got: dict, plain: dict, where: str) -> int:
    """Every state leaf and the lines buffer of K2's frame bit-equal to the
    plain frame's; returns the largest absolute difference over them."""
    import torch

    err = 0
    for k in plain:
        a, b = got[k].to(torch.int64), plain[k].to(torch.int64)
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    bad = [k for k in plain if not torch.equal(got[k], plain[k])]
    _check(not bad, f"K2 differs from plain on {where}: {bad} (max_abs_err {err})")
    return err


def phase_k2_vs_plain(device: str) -> int:
    """K2 against its plain version on every cart, and the collision bits
    on random register files; returns the largest absolute difference."""
    import torch

    from envpool_tpu_torch.envs.atari import machine_kernel
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.tools.k2_probe import carts, machines

    mc = carts()
    cases = [  # (name, rom, lanes, frames, lanes get different inputs)
        ("pong", mc.pong_rom(), 32, 3, True),
        ("f8", mc.f8_rom(), 20, 2, True),
        ("f6", mc.f6_rom(), 20, 2, True),
        ("random0", mc.random_rom(0), 20, 1, False),
    ]
    max_err = 0
    for name, rom, n, frames, differ in cases:
        tables = machine_kernel.build_tables(rom, device)
        got = plain = machines(rom, n, differ, device)
        for f in range(frames):
            got = machine_frame(got, tables)
            plain = machine_kernel.frame(plain, tables)
            torch.cuda.synchronize()
            max_err = max(max_err, _k2_vs_plain(got, plain, f"{name} frame {f}"))
        print(f"K2 vs plain [{name}, {n} lanes x {frames} frames]: 0 mismatched "
              f"leaves of {len(plain)}; cycles {int(got['cycles'][0])}, "
              f"bank {int(got['bank'][0])}, scanline {int(got['scanline'][0])}")
    rng = np.random.default_rng(7)
    rec = rng.integers(0, 256, (512, 24)).astype(np.int32)
    rec[:, 10:12] = rng.integers(0, 160, (512, 2))
    rec[:, 17:20] = rng.integers(0, 160, (512, 3))
    rec_t = torch.as_tensor(rec)
    got = machine_frame.collisions(rec_t.to(device)).cpu()
    want = machine_kernel.collisions(rec_t).to(torch.int32)
    bad = int((got != want).sum())
    _check(bad == 0, "K2's collision bits differ from the plain version")
    print(f"K2 collision bits vs plain on 512 random records: {bad} mismatches")
    return max(max_err, int((got - want).abs().max()))


def _k2_steady(device: str, n: int, frames: int, tables, rom):
    """K2 over ``frames`` steady pong frames at ``n`` machines (after 6
    warm-up frames, as bench.py does): ms per frame, the emulated cycles,
    each frame's largest instruction count, and the last state."""
    import torch

    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.tools.k2_probe import machines

    g = machines(rom, n, device=device)
    for _ in range(6):
        g = machine_frame(g, tables)
    counts = torch.zeros((frames, n), dtype=torch.int32, device=device)
    c0 = g["cycles"].to(torch.int64)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for f in range(frames):
        g = machine_frame(g, tables, counts[f])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames
    dcyc = int(((g["cycles"].to(torch.int64) - c0) % 2**32).sum())
    return ms, dcyc, counts.max(1).values.to(torch.float64), g


def phase_k2_timing(device: str, n: int, wide: int) -> dict:
    """K2 frames/s and emulated 6502 cycles/s on the pong cart at ``n``
    machines in 20 steady frames, the plain version's time for one frame,
    and K2's two bounds: bytes, and the chain of dependent emulated
    instructions (each frame's most instructions on one machine x one
    dependent shared-memory load, measured here).  K2's next frame of the
    same state is then held against that plain frame, instruction counts
    included.  The same timing runs at ``wide`` machines."""
    import torch

    from envpool_tpu_torch.envs.atari import machine_kernel
    from envpool_tpu_torch.ops.cuda_machine import NS, machine_frame
    from envpool_tpu_torch.tools.k2_probe import carts, smem_latency, smi

    rom = carts().pong_rom()
    tables = machine_kernel.build_tables(rom, device)
    frames = 20
    clocks, load_ns = smem_latency(machine_frame)
    sm_clock = smi("clocks.sm")
    print(f"dependent shared-memory load (one-thread pointer chase): "
          f"{clocks:.2f} SM clocks = {load_ns:.3f} ns at SM clock {sm_clock}")
    rows = {}
    for width in (n, wide):
        ms, dcyc, most, g = _k2_steady(device, width, frames, tables, rom)
        chain_ms = float(most.mean()) * load_ns * 1e-6
        rows[width] = ms, chain_ms, g
        print(
            f"K2 at {width} machines, pong cart, {frames} steady frames: {ms:.4f} "
            f"ms/frame = {width / ms * 1e3:,.0f} machine-frames/s; {dcyc} emulated "
            f"6502 cycles = {dcyc / (ms * frames / 1e3):,.0f} cycles/s; most "
            f"instructions on one machine {float(most.mean()):.1f} per frame; chain "
            f"bound {chain_ms:.5f} ms = {chain_ms / ms:.4f} of K2's time"
        )
    k2_ms, chain_ms, g = rows[n]
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    want = torch.zeros(n, dtype=torch.int32, device=device)
    t0.record()
    plain = machine_kernel.frame(g, tables, want)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    got = torch.zeros_like(want)
    k2 = machine_frame(g, tables, got)
    torch.cuda.synchronize()
    max_err = _k2_vs_plain(k2, plain, f"pong, {n} machines, steady frame")
    _check(torch.equal(got, want), "K2's instruction counts differ from plain")
    print(f"K2 vs plain [pong, {n} lanes, frame 27]: 0 mismatched leaves of "
          f"{len(plain)}, instruction counts equal; plain version {plain_ms:.1f} ms "
          f"for one frame")
    # Bytes the frame must move: every state leaf in and out, the line
    # records it writes, and the cart's fetch table once.
    per_machine = (NS + 128 + 64 + 8) * 4 * 2 + 192 * 24 * 4
    nbytes = n * per_machine + tables["fetch"].numel() * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(
        f"K2 bounds at {n} machines: bytes {nbytes / 1e6:.2f} MB / 3.35 TB/s = "
        f"{bytes_ms:.5f} ms; operations: the chain of dependent emulated "
        f"instructions, {chain_ms:.5f} ms (each frame's most instructions on one "
        f"machine x {load_ns:.3f} ns); K2 reaches {chain_ms / k2_ms:.4f} of the "
        f"chain bound"
    )
    return {
        "max_abs_err": max_err,
        "ms": k2_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, chain_ms),
        "bound_by": "operations" if chain_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def _write_cart(rom) -> str:
    path = REPO / "envpool_tpu_torch" / "_build" / "carts" / "pong_like.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(rom.tobytes())
    return str(path)


MACHINE = {"ram_reward_addr": 0x81, "ram_lives_addr": 0x87}


def phase_machine_adapters(device: str, n: int, rom_path: str) -> int:
    """Machine2600-v0 at registered defaults through gymnasium, dm and the
    functional handle; returns K2 launches per engine step."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.ops.cuda_machine import machine_frame

    env = _pool(device, "Machine2600-v0", n, rom_path=rom_path, **MACHINE)
    obs, info = env.reset()
    rng = np.random.default_rng(SEED)
    rewards, terms, resets = 0, 0, 0
    steps = 40
    before = machine_frame.launches
    for t in range(steps):
        act = torch.as_tensor(rng.integers(0, 18, n, dtype=np.int32))
        obs, rew, term, trunc, info = env.step(act)
        rewards += int((rew > 0).sum())
        terms += int(term.sum())
        resets += int((info["elapsed_step"] == 0).sum())
    per_step = (machine_frame.launches - before) / steps
    _check(tuple(obs.shape) == (n, 4, *OUT_HW), f"obs shape {tuple(obs.shape)}")
    _check(obs.dtype == torch.uint8, f"obs dtype {obs.dtype}")
    _check(obs.device.type == torch.device(device).type, f"obs on {obs.device}")
    _check(int(obs.float().std()) > 0 or bool((obs > 0).any()), "blank obs")
    _check(rewards > 0, "no reward in the gymnasium run")
    _check(terms > 0 and resets > 0, "no termination with auto-reset")
    print(
        f"Machine2600-v0 gymnasium: obs {tuple(obs.shape)} {obs.dtype} on "
        f"{obs.device}; {steps} random steps: {rewards} points, {terms} "
        f"terminations, {resets} auto-resets; K2 launches per step {per_step:g}"
    )

    dm = envpool_tpu_torch.make_dm(
        "Machine2600-v0", num_envs=n, seed=SEED, device=device, rom_path=rom_path,
        **MACHINE,
    )
    ts = dm.reset()
    _check(bool((ts.step_type == 0).all()), "dm reset step_type")
    for _ in range(3):
        ts = dm.step(rng.integers(0, 18, n, dtype=np.int32))
    _check(ts.observation.obs.shape == (n, 4, *OUT_HW), "dm obs shape")
    print(f"Machine2600-v0 dm: 3 steps, obs {ts.observation.obs.shape}, "
          f"step_type {sorted(set(ts.step_type.tolist()))}")

    handle, recv, send, step = env.xla()
    for _ in range(3):
        act = torch.as_tensor(rng.integers(0, 18, n, dtype=np.int32), device=device)
        handle, (obs, rew, term, trunc, info) = step(handle, act)
    _check(tuple(obs.shape) == (n, 4, *OUT_HW), "functional obs shape")
    print(f"Machine2600-v0 functional: 3 steps, obs {tuple(obs.shape)}")
    return per_step


# ---------------------------------------------------------------------------
# CartPole-v1 (classic control) and HalfCheetah-v4 (the rigid-body physics)
# ---------------------------------------------------------------------------


def _obs_shapes(pool, n: int) -> dict:
    """``{name: (n, ...)}`` of a pool's observation fields: ``obs`` for a
    single array, else each ``obs:<name>`` (dm_control's dict obs)."""
    spec = pool.spec.state_array_spec
    return {k.removeprefix("obs:"): (n, *v.shape) for k, v in spec.items()
            if k == "obs" or k.startswith("obs:")}


def phase_float_adapters(device: str, task: str, n: int, episode: int,
                         dm_episode: bool = False, **make_kwargs) -> dict:
    """A classic-control or physics task through the gymnasium pool made
    with no ``device`` argument (which must land on ``device``), a dm pool
    and the functional handle; the gymnasium pool truncates at ``episode``
    steps.  With ``dm_episode``, the dm pool runs an episode of ``episode``
    steps too: discount 1.0 on every step, LAST at the truncation and FIRST
    after it (dm_control's time-limit-only episodes).  ``make_kwargs`` go
    to every pool.  Returns what the gymnasium run saw."""
    import torch

    import envpool_tpu_torch

    pool = envpool_tpu_torch.make(
        task, env_type="gymnasium", num_envs=n, seed=SEED, numpy_output=False,
        max_episode_steps=episode, **make_kwargs,
    )
    _check(pool.pool_state.key.device.type == device, "default device is not the card")
    sample = _sampler(_spec(pool), n, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = _obs_shapes(pool, n)

    def fields(obs):
        return obs if isinstance(obs, dict) else {"obs": obs}

    obs, info = pool.reset()
    seen = {"terminated": 0, "truncated": 0, "resets": 0}
    reward = 0.0
    for _ in range(episode + 2):
        obs, rew, term, trunc, info = pool.step(sample(gen))
        seen["terminated"] += int((term & ~trunc).sum())
        seen["truncated"] += int(trunc.sum())
        seen["resets"] += int((info["elapsed_step"] == 0).sum())
        reward += float(rew.sum())
    got = {k: tuple(v.shape) for k, v in fields(obs).items()}
    _check(got == shapes, f"obs shapes {got}, expected {shapes}")
    dtypes = {k.removeprefix("obs:"): v.torch_dtype
              for k, v in pool.spec.state_array_spec.items()}
    for k, v in fields(obs).items():
        _check(v.dtype == dtypes[k] and v.device.type == device,
               f"obs {k}: {v.dtype} on {v.device}")
        _check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
    _check(np.isfinite(reward), "non-finite reward")
    _check(seen["truncated"] > 0 and seen["resets"] > 0,
           f"truncation at {episode} steps and auto-reset: {seen}")
    print(f"{task} gymnasium (no device argument: {device}): obs {got}; "
          f"{episode + 2} random steps: {seen}, reward sum {reward:.6g}")

    dm = envpool_tpu_torch.make_dm(task, num_envs=n, seed=SEED, device=device, **make_kwargs,
                                   **({"max_episode_steps": episode} if dm_episode else {}))
    ts = dm.reset()
    _check(bool((ts.step_type == 0).all()), "dm reset step_type")
    for t in range(1, (episode + 1 if dm_episode else 3) + 1):
        ts = dm.step(sample(gen).cpu().numpy())
        if dm_episode:
            want = 2 if t == episode else 0 if t == episode + 1 else 1
            _check(bool((ts.step_type == want).all()),
                   f"dm step_type at step {t}: {sorted(set(ts.step_type.tolist()))}, "
                   f"expected {want}")
            _check(bool((ts.discount == 1.0).all()), f"dm discount at step {t}")
    for k, shape in shapes.items():
        v = getattr(ts.observation, k)
        _check(v.shape == shape and bool(np.isfinite(v).all()), f"dm obs {k}")
    print(f"{task} dm: {t} steps, obs {sorted(shapes)}, step_type "
          f"{sorted(set(ts.step_type.tolist()))}"
          + (f"; discount 1.0 throughout, LAST at step {episode}, FIRST after"
             if dm_episode else ""))

    handle, recv, send, step = pool.xla()
    for _ in range(3):
        handle, (obs, rew, term, trunc, info) = step(handle, sample(gen))
    got = {k: tuple(v.shape) for k, v in fields(obs).items()}
    _check(got == shapes and all(v.device.type == device for v in fields(obs).values()),
           "functional obs")
    print(f"{task} functional: 3 steps, obs {got} on {device}")
    return seen


def _cartpole_margin(ts):
    """``[N]`` distance of each new CartPole state to its termination
    thresholds."""
    import torch

    obs = ts["obs"]
    return torch.minimum(
        (obs[:, 0].abs() - 2.4).abs(),
        (obs[:, 2].abs() - 12 * 2 * np.pi / 360).abs(),
    )


def _float64(tree, device):
    """A state tree on ``device``, its float tensors in float64."""
    import torch

    from envpool_tpu_torch.core.engine import _tree_map

    return _tree_map(lambda x: x.to(device, torch.float64 if x.is_floating_point()
                                    else x.dtype), tree)


def _physics_f64(env, state, act, device):
    """``[N, nq + nv]``: qpos and qvel after one env step of every row of an
    env state in float64 (on the card, which runs float64 at its float32
    rate), on the CPU."""
    import torch

    out = env.physics_step(_float64(state, device), act.to(device, torch.float64))
    return torch.cat(out, 1).cpu()


def _rows(tree, idx):
    from envpool_tpu_torch.core.engine import _tree_map

    return _tree_map(lambda x: x[idx], tree)


def _rel(a, b):
    """``[N]``: the largest ``|a - b| / (1 + |b|)`` of each row, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (1 + b.abs())).amax(-1)


def float32_spread(fn, args, ref):
    """``[M]``: the farthest that ``fn`` in float32 on the CPU lands from
    its float64 result ``ref`` ``[M, m]``, over ``fn(*args)`` and
    ``SPREAD_MOVES`` calls on ``args`` with every element moved up or down
    by an ulp or two at random: how far float32 alone carries ``fn`` from
    float64 on these inputs, whatever device runs it."""
    import torch

    gen = torch.Generator().manual_seed(SEED)

    def far(x):  # a move that leaves the finite numbers lies infinitely far
        return torch.nan_to_num(_rel(x, ref), nan=float("inf"))

    out = far(fn(*args))
    for _ in range(SPREAD_MOVES):
        moved = [x * (1 + (2 * torch.randint(0, 2, x.shape, generator=gen) - 1) * 2.0**-23)
                 for x in args]
        out = torch.maximum(out, far(fn(*moved)))
    return out


def _quantiles(x) -> str:
    return "/".join(f"{float(v):.3g}" for v in np.quantile(x.numpy(), [0.99, 0.999, 1.0]))


def _substep_model(env):
    """The env's model with the timestep of one substep, and the dtype its
    physics steps in."""
    import dataclasses

    import torch

    model = dataclasses.replace(env.model, timestep=env.model.timestep / env.substeps)
    return model, torch.promote_types(torch.float32, env.physics_dtype or torch.float32)


def _physics_state(ps) -> tuple:
    """``(qpos, qvel)`` of a pool state, on the CPU."""
    return tuple(ps.env_state[k].cpu() for k in ("qpos", "qvel"))


def card_sides(env, ps, act, device) -> list:
    """The card's side of :func:`_physics_crossed`: the switch sides
    (``dynamics.switch_sides``) after each substep but the last of every
    row of a pool state ``ps`` on the CPU, stepped one substep at a time on
    the card, as CPU tensors."""
    from envpool_tpu_torch.physics import dynamics

    model, dtype = _substep_model(env)
    cq, cqd = (ps.env_state[k].to(dtype).to(device) for k in ("qpos", "qvel"))
    cact = env.control(ps.env_state, act).to(dtype).to(device)
    out = []
    for _ in range(env.frame_skip * env.substeps - 1):
        cq, cqd = dynamics.step(model, cq, cqd, cact, 1, env.contact)
        out.append(dynamics.switch_sides(model, cq, env.contact).cpu())
    return out


def _physics_crossed(env, ps, act, sides):
    """The CPU's env step of every row of a pool state, taken one substep
    at a time, and ``[N]`` True where the card's and the CPU's substeps put
    a stepped env on different sides of a switch of the penalty forces (a
    contact's or a pair's depth crossing 0, a joint or a limited spatial
    tendon crossing its limit, a pair's closest points changing formula;
    ``dynamics.switch_sides``): the forces
    jump there, so the two may part by far more than rounding.  Returns
    ``((qpos, qvel), crossed)``; the step is the env's ``physics_step``
    bit for bit.  The card's sides are :func:`card_sides`'."""
    import torch

    from envpool_tpu_torch.physics import dynamics

    model, dtype = _substep_model(env)
    q, qd = (ps.env_state[k].to(dtype) for k in ("qpos", "qvel"))
    ctrl = env.control(ps.env_state, act).to(dtype)
    crossed = torch.zeros(q.shape[0], dtype=torch.bool)
    for i in range(env.frame_skip * env.substeps):
        q, qd = dynamics.step(model, q, qd, ctrl, 1, env.contact)
        if i + 1 == env.frame_skip * env.substeps:
            break  # the last substep's sides do not change the step
        crossed |= (sides[i] != dynamics.switch_sides(model, q, env.contact)).any(1)
    return (q.float(), qd.float()), crossed & ~ps.autoreset


def _tree_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def phase_float_card_vs_cpu(device: str, task: str, n: int, warmup: int,
                            steps: int, tol: float, spread: bool = False,
                            warm: dict | None = None, later: CpuSide | None = None,
                            family: str | None = None, **make_kwargs):
    """After ``warmup`` random steps on the card, ``steps`` engine steps
    each taken on the card and on the CPU from the same pool state and
    action: float fields within ``tol * (1 + |cpu|)``, the rest equal
    (``tol`` 0: toy_text's and Dummy's fields, all exact, equal).  A
    done flag may differ only where the new state lies within ``tol`` of
    its task's termination bound (and then the reward and discount with
    it): for CartPole, its thresholds; for the physics, the env's own
    ``termination_margin``.  ``make_kwargs`` go to both pools.

    For the physics, the new state itself is held to ``tol``: an env whose
    substeps fall on different sides of a penalty-force switch on the card
    and on the CPU is left out, and every stepped env is also stepped in
    float64.  An env past the tolerance passes only where float32 is at
    fault and not the card: where the card's float32 step lies within
    ``tol / 2`` of float64 and the CPU's does not; or, with ``spread``,
    where the card's lies within ``tol`` of float64, or within
    ``SPREAD_FACTOR`` times the farthest that the CPU's float32 steps from
    that state and from its neighbours an ulp away land from it
    (:func:`float32_spread`).  (Each at most 1% of the envs,
    :func:`check_shares`.)  For the ``DIVERGING_CLASSES`` alone, an env
    whose state is not finite on entry, or whose float64 step is not, or
    whose float32 step is not on both devices alike, is left out and
    counted: the reference's penalty physics diverges on some manipulator
    and stacker states (light fingers in a stiff explicit contact), on
    every device.  A state that leaves the finite numbers on one device
    only, or on any device for any other id, fails.  What the env derives from its new state (obs,
    reward, done) the CPU computes from the card's new state, since an
    observation such as a contact force (``kp`` times a depth) scales the
    state's rounding by 1e4; an obs past the tolerance passes by the same
    rule, against the float64 obs of that state.  The caller allows TF32,
    and the physics must still run its matmuls without it.

    With ``warm``, ids that step one model alike and whose resets agree
    share one warm-up: the first warms up and stores its state there, the
    next starts its checked steps from it (dm_control tasks of one domain,
    which never terminate within the warm-up, differ in reward and obs
    alone).

    The card takes its warm-up and checked steps first; the CPU's side of
    every checked step and the arbitration on the card (the float64 step,
    the switch sides of the card's substeps) follow (:func:`cpu_side`), in
    ``later``'s worker process if it is given (with :func:`check_shares`
    there, the result kept for the short checks' ``family``), while the
    caller goes on with the card's work.  The line it prints ends with the
    seconds of the card's warm-up, of its checked steps and of the CPU's
    side.

    Returns the counts it printed and each stepped env's distance to
    float64 on the card and on the CPU, of its state and of its obs, for
    :func:`check_shares` and :func:`check_f64_parity`; with ``later``, the
    future of its job."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core.engine import Engine, PoolState, _tree_map
    from envpool_tpu_torch.envs.physics_env import PhysicsEnv
    from envpool_tpu_torch.physics import dynamics

    card = _pool(device, task, n, **make_kwargs)
    cpu = Engine(envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED,
                                             device="cpu", **make_kwargs).env)
    env = cpu.env
    eng = card.engine
    gen = torch.Generator().manual_seed(SEED)
    sample = _sampler(_spec(card), n, "cpu")
    ps, _ = eng.reset(card.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    physics = isinstance(env, PhysicsEnv)
    t0 = time.perf_counter()
    key = physics and (type(env), env.model, env.contact, env.substeps,
                       env.frame_skip, env.physics_dtype)
    shared = warm.get(key) if warm is not None and physics else None
    if shared is not None and _tree_equal(shared[0], ps.env_state):
        for _ in range(warmup):  # the same actions from here on
            sample(gen)
        ps = shared[1]
    else:
        start = ps.env_state
        for _ in range(warmup):
            ps, _ = eng.step(ps, {"action": sample(gen).to(device)})
        if warm is not None and physics:
            warm[key] = (start, ps)
    torch.cuda.synchronize()
    card_s = [time.perf_counter() - t0]
    matmul = torch.backends.cuda.matmul
    tf32_seen = set()
    solve = dynamics.spd_solve
    not_spd = [0]

    def spy(M, b):
        # On the card: every matrix the step solves must be SPD (a row
        # that is not comes out NaN), unless the state had already left
        # the finite numbers.
        tf32_seen.add(matmul.fp32_precision)
        x = solve(M, b)
        finite_in = torch.isfinite(M).flatten(-2).all(-1) & torch.isfinite(b).all(-1)
        not_spd[0] += int(((~torch.isfinite(x)).any(-1) & finite_in).sum())
        return x

    # The card's side of each checked step: the step itself (a caller that
    # allows TF32, the spy on the solve), its timestep, and for the physics
    # its new qpos and qvel.
    card_steps = []
    for t in range(steps):
        act = sample(gen)
        ps_cpu = PoolState(*(_tree_map(lambda x: x.cpu(), f) for f in (
            ps.env_state, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)))
        dynamics.spd_solve = spy
        matmul.fp32_precision = "tf32"  # a caller that allows TF32
        try:
            ps, got = eng.step(ps, {"action": act.to(device)})
            torch.cuda.synchronize()
            restored = matmul.fp32_precision == "tf32"
        finally:
            dynamics.spd_solve = solve
            matmul.fp32_precision = "ieee"
        got = {k: v.cpu() for k, v in got.items()}
        card_steps.append((act, ps_cpu, got, restored, _physics_state(ps) if physics else None))

    card_s.append(time.perf_counter() - t0 - card_s[0])
    args = (task, n, warmup, steps, tol, spread, make_kwargs, card_steps, tf32_seen, not_spd[0],
            card_s)
    if later is None:
        return cpu_side(*args, device=device, cpu=cpu, eng=eng)
    return later.submit(cpu_side, *args, device=device, family=family)


def cpu_side(task: str, n: int, warmup: int, steps: int, tol: float, spread: bool,
             make_kwargs: dict, card_steps: list, tf32_seen: set, not_spd: int,
             card_s: list, device: str = "cuda", cpu=None, eng=None,
             family: str | None = None):
    """The CPU's side of :func:`phase_float_card_vs_cpu`: each checked step
    of the card (``card_steps``: the action, the pool state before it on
    the CPU, the card's timestep, whether the step restored the caller's
    TF32 flag, and for the physics the card's new qpos/qvel, which it
    arbitrates with a float64 step and the switch sides of the card's
    substeps, both on ``device``) held to the CPU's, every ``_check`` in
    its order; returns the counts and distances it printed (``card_s``:
    the seconds of the card's warm-up and checked steps, for its line).
    In the caller's process ``cpu`` is the caller's CPU engine and ``eng``
    the card's (a failure report steps the card again); in
    :class:`CpuSide`'s worker process it builds its own CPU engine, runs
    :func:`check_shares` on its result at once and keeps the result for
    the family's :func:`family_checks`."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core.engine import Engine, PoolState
    from envpool_tpu_torch.envs.physics_env import PhysicsEnv

    t0 = time.perf_counter()
    if cpu is None:
        cpu = Engine(envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED, device="cpu",
                                                 **make_kwargs).env)
    env = cpu.env
    physics = isinstance(env, PhysicsEnv)
    may_diverge = type(env).__name__ in DIVERGING_CLASSES
    rel = _rel
    # The card's largest distance to float64 over its limit, of the envs
    # past the tolerance: state, obs.
    ratios = [0.0, 0.0]

    def f32_at_fault(which, card64, cpu64, fn, args, ref):
        # [M] over the M envs past the tolerance: float32 is at fault
        # there, and not the card.
        if not spread:
            return (card64 <= tol / 2) & (cpu64 > tol / 2)
        limit = torch.clamp(SPREAD_FACTOR * float32_spread(fn, args, ref), min=tol)
        ratios[which] = max(ratios[which], float((card64 / limit).max()))
        return card64 <= limit


    worst, skipped, flips, resets, arbitrated, terms = 0.0, 0, 0, 0, 0, 0
    n_diverged = 0
    f64 = (0.0, 0.0, 0.0)  # worst qpos/qvel row: card-cpu, card-f64, cpu-f64
    # Each stepped env's distance to float64: its state, and its obs.
    to_f64 = {"card": [], "cpu": [], "card_obs": [], "cpu_obs": []}
    obs_arbitrated = 0
    for t, (act, ps_cpu, got, restored, card) in enumerate(card_steps):
        _check(restored, "the step did not restore the caller's TF32 setting")
        if physics:
            # The physics state: the card's float32 step against the CPU's,
            # and both against a float64 step.
            theirs, state = card, ps_cpu.env_state
            sides = card_sides(env, ps_cpu, act, device)
            ref = _physics_f64(env, state, act, device)
            mine, skip = _physics_crossed(env, ps_cpu, act, sides)
            a, b = torch.cat(theirs, 1), torch.cat(mine, 1)
            # Envs whose state left the finite numbers (the reference's
            # physics diverges on some manipulator and stacker states): on
            # entry, in the float64 step, or on both devices in this step.
            finite = [torch.isfinite(x).all(1) for x in
                      (torch.cat([state["qpos"], state["qvel"]], 1), a, b, ref)]
            one_side = (finite[1] != finite[2]) & finite[0] & ~ps_cpu.autoreset
            _check(not bool(one_side.any()), f"{int(one_side.sum())} envs' states left the "
                   f"finite numbers on one device only at step {t}")
            diverged = ~(finite[0] & finite[1] & finite[3]) & ~ps_cpu.autoreset
            _check(may_diverge or not bool(diverged.any()),
                   f"{int(diverged.sum())} envs' states left the finite numbers at step {t}")
            n_diverged += int(diverged.sum())
            stepped = ~(ps_cpu.autoreset | skip | diverged)
            card64, cpu64 = rel(a, ref), rel(b, ref)
            to_f64["card"].append(card64[stepped])
            to_f64["cpu"].append(cpu64[stepped])
            err = rel(a, b).masked_fill(~stepped, 0)
            i = int(err.argmax())
            if float(err[i]) > f64[0]:
                f64 = (float(err[i]), float(card64[i]), float(cpu64[i]))
            idx = (err > tol).nonzero()[:, 0]
            if len(idx):
                rows = _rows(state, idx)
                at_fault = f32_at_fault(
                    0, card64[idx], cpu64[idx],
                    lambda q, qd: torch.cat(env.physics_step(
                        dict(rows, qpos=q, qvel=qd), act[idx]), 1),
                    (rows["qpos"], rows["qvel"]), ref[idx])
                arbitrated += len(idx)
                _check(bool(at_fault.all()),
                       f"{int((~at_fault).sum())} envs' physics states differ by more "
                       f"than {tol:g} at step {t}, where float32 is not at fault")
            # Everything the env derives from its new state (obs, reward,
            # done): the CPU's own functions on the card's new state.
            env.physics_step = lambda *args, **kwargs: theirs
            try:
                cps, want = cpu.step(ps_cpu, {"action": act})
            finally:
                del env.physics_step
            flip_ok = env.termination_margin(cps.env_state) < tol
            new_state = env.next_state(state, act, *theirs)
            obs_keys = list(env.obs_fields(_rows(new_state, slice(0, 1))))

            def flat_obs(st):
                fields = env.obs_fields(st)
                return torch.cat([fields[k].reshape(st["qpos"].shape[0], -1)
                                  for k in obs_keys], 1)

            obs64 = flat_obs(_float64(new_state, "cpu"))
        else:
            obs_keys = []
            skip = diverged = torch.zeros(n, dtype=torch.bool)
            cps, want = cpu.step(ps_cpu, {"action": act})
            flip_ok = (_cartpole_margin(want) < tol if task.startswith("CartPole")
                       else torch.zeros(n, dtype=torch.bool))
        flipped = (got["done"].cpu() != want["done"]) & flip_ok & ~skip
        flips += int(flipped.sum())
        skipped += int(skip.sum())
        resets += int((want["step_type"] == 0).sum())
        terms += int((want["done"] & ~want["trunc"]).sum())
        bad = torch.zeros(n, dtype=torch.bool)
        bad_fields = {}  # field -> its largest error among the envs past tol
        # A physics env's obs fields are held as one block.
        fields = {k: (got[k].cpu(), w) for k, w in want.items() if k not in obs_keys}
        if obs_keys:
            fields["obs"] = tuple(torch.cat([x[k].cpu().reshape(n, -1) for k in obs_keys], 1)
                                  for x in (got, want))
        for k, (g, w) in fields.items():
            _check(not w.is_floating_point() or bool(torch.isfinite(g[~diverged]).all()),
                   f"{k} not finite on the card at step {t}")
            excused = skip | diverged | (flipped if k in ("reward", "discount") else skip)
            if w.is_floating_point():
                err = rel(g.reshape(n, -1), w.reshape(n, -1))
                worst = max(worst, float(err[~excused].max()))
                past = (err > tol) & ~excused
                if obs_keys and k == "obs":
                    # Contact forces in an obs (kp times a depth, kd times a
                    # speed) carry float32's rounding past the tolerance on
                    # some states; there float64 shows a float32 obs off.
                    card_o, cpu_o = rel(g, obs64), rel(w, obs64)
                    to_f64["card_obs"].append(card_o[~excused])
                    to_f64["cpu_obs"].append(cpu_o[~excused])
                    idx = past.nonzero()[:, 0]
                    if len(idx):
                        rows = _rows(new_state, idx)
                        at_fault = f32_at_fault(
                            1, card_o[idx], cpu_o[idx],
                            lambda q, qd: flat_obs(dict(rows, qpos=q, qvel=qd)),
                            (rows["qpos"], rows["qvel"]), obs64[idx])
                        obs_arbitrated += int(at_fault.sum())
                        past[idx[at_fault]] = False
                bad |= past
                if bool(past.any()):
                    i = int(err.masked_fill(~past, 0).argmax())
                    bad_fields[k] = (
                        f"{float(err[i]):.3g} at env {i} (reset row "
                        f"{bool(ps_cpu.autoreset[i])}, elapsed {int(ps_cpu.elapsed[i])}): "
                        f"card {g.reshape(n, -1)[i, :8].tolist()}, "
                        f"cpu {w.reshape(n, -1)[i, :8].tolist()}")
            else:
                differ = (g != w).reshape(n, -1).any(1) & ~skip
                if k in ("done", "step_type"):
                    differ &= ~flipped
                _check(not bool(differ.any()), f"{k} differs at step {t}")
        if bool(bad.any()) and not physics:
            if want.get("obs") is not None and want["obs"].is_floating_point():
                # Which side is off: both against the CPU's float64 step.
                _, want64 = cpu.step(PoolState(_float64(ps_cpu.env_state, "cpu"), *(
                    ps_cpu.key, ps_cpu.elapsed, ps_cpu.autoreset, ps_cpu.full_reset)),
                    {"action": act})
                ref = want64["obs"].reshape(n, -1)
                bad_fields["float64 step"] = (
                    f"card {float(rel(got['obs'].cpu().reshape(n, -1), ref)[bad].max()):.3g}, "
                    f"cpu {float(rel(want['obs'].reshape(n, -1), ref)[bad].max()):.3g} "
                    f"off on those envs; {int((bad & ps_cpu.autoreset).sum())} reset rows")
            say(failure_report(bad, eng, cpu, ps_cpu, act, got, want, device))
        _check(not bool(bad.any()),
               f"{int(bad.sum())} envs differ by more than {tol:g} at step {t} "
               f"(largest per field: {bad_fields})")
    f64s = {k: torch.cat(v) if physics else torch.zeros(0) for k, v in to_f64.items()}
    _check(not physics or tf32_seen == {"ieee"},
           f"TF32 inside the physics step: fp32_precision seen {tf32_seen}")
    _check(not_spd == 0, f"{not_spd} matrices of the step not SPD on the card")
    say(
        f"{task} card vs CPU, {n} envs x {steps} steps from the same states "
        f"(after {warmup} warm-up steps; {resets} resets, {terms} terminations "
        f"among them): largest |card - cpu| / (1 + |cpu|) = {worst:.3g} "
        f"(tolerance {tol:g}); done flags that differ at a threshold: {flips}; "
        f"envs left out on different sides of a penalty-force switch: {skipped}"
        + (f"; envs left out whose state left the finite numbers (on both devices "
           f"alike): {n_diverged}" if n_diverged else "")
        + (f"; on the env whose qpos/qvel differ most ({f64[0]:.3g}), a float64 "
           f"step puts the card at {f64[1]:.3g} and the CPU at {f64[2]:.3g}; "
           f"envs past the tolerance where float32 is at fault "
           f"({'spread' if spread else 'strict'} rule): state {arbitrated}, obs "
           f"{obs_arbitrated}"
           + (f" (the card's distance to float64 over its limit there: at most "
              f"{ratios[0]:.3g} and {ratios[1]:.3g})" if spread else "")
           + "; TF32 off inside every physics step "
           "while the caller allowed it; every matrix solved on the card SPD"
           if physics else "")
        + f" (the card's warm-up {card_s[0]:.1f} s, its checked steps {card_s[1]:.1f} s; "
        f"the CPU's side {time.perf_counter() - t0:.1f} s)"
    )
    out = {"worst": worst, "flips": flips, "skipped": skipped, "checked": n * steps,
           "resets": resets,
           "diverged": n_diverged, "diverge_share": DIVERGE_SHARE if may_diverge else 0.0,
           "arbitrated": arbitrated, "obs_arbitrated": obs_arbitrated, **f64s}
    if family is None:
        return out
    check_shares(task, out)
    _FAMILY_RESULTS.setdefault(family, []).append(out)
    return None


def _runs(idx: np.ndarray) -> list[tuple[int, int]]:
    """The sorted indices ``idx`` as contiguous runs ``(first, last)``."""
    if not len(idx):
        return []
    cut = np.flatnonzero(np.diff(idx) != 1)
    return list(zip(idx[np.r_[0, cut + 1]].tolist(), idx[np.r_[cut, len(idx) - 1]].tolist()))


def failure_report(bad, eng, cpu, ps_cpu, act, got, want, device) -> str:
    """What a failed card-vs-CPU step of an env without physics tells about
    where it went wrong: the failing envs as contiguous runs, their count in
    each aligned block of 2048 and of 512 envs, and whether stepping the
    same state and action again on the card (given its engine ``eng``, which
    a worker process lacks), and on the CPU with one thread, gives each
    side's own result bit for bit (a fault that comes and goes, or one that
    the CPU's threads bring)."""
    import torch

    from envpool_tpu_torch.core.engine import PoolState, _tree_map

    def same(a, b):
        return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    n = bad.shape[0]
    idx = bad.nonzero()[:, 0].numpy()
    runs = _runs(idx)
    blocks = {size: np.bincount(idx // size, minlength=-(-n // size)).tolist()
              for size in (2048, 512)}
    again = "not run (no card engine in the worker process)"
    if eng is not None:
        ps_card = PoolState(*(_tree_map(lambda x: x.to(device), f) for f in (
            ps_cpu.env_state, ps_cpu.key, ps_cpu.elapsed, ps_cpu.autoreset, ps_cpu.full_reset)))
        _, step = eng.step(ps_card, {"action": act.to(device)})
        torch.cuda.synchronize()
        again = same(step, got)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, one = cpu.step(ps_cpu, {"action": act})
    finally:
        torch.set_num_threads(threads)
    return (f"failure report: {len(idx)} envs in {len(runs)} contiguous runs "
            f"(first {runs[:8]}, last {runs[-8:]}); per aligned block of 2048 envs "
            f"{blocks[2048]}, of 512 envs {blocks[512]}; the card again from the same "
            f"state and action gives its own result bit for bit: {again}; the "
            f"CPU on 1 thread (of {threads}) gives its own: {same(one, want)}")


def check_shares(what: str, v: dict) -> None:
    """Of the envs stepped in one card-vs-CPU phase ``v``, at most 1% left
    out across a penalty-force switch and at most 1% whose state passed
    only because float32 is at fault there; of the ``DIVERGING_CLASSES``,
    at most ``DIVERGE_SHARE`` whose state left the finite numbers on both
    devices (of any other id, none).  (An obs past the tolerance is
    held by its own limit alone: on HumanoidStandup, lying on its
    contacts, two float32 computations of the obs of one state part by
    more than the tolerance in over 1% of env steps.)"""
    for key, why in (("skipped", "on different sides of a penalty-force switch"),
                     ("arbitrated", "past the tolerance where float32 is at fault")):
        _check(v[key] <= 0.01 * v["checked"], f"{what}: {v[key]} of {v['checked']} envs {why}")
    _check(v["diverged"] <= v["diverge_share"] * v["checked"],
           f"{what}: {v['diverged']} of {v['checked']} envs left the finite numbers")


def check_f64_parity(what: str, card64, cpu64, tol: float) -> None:
    """Over many stepped envs, the card's float32 steps are as close to a
    float64 step as the CPU's: the 99th and 99.9th percentiles of the
    distance within 2x (plus 1e-6), the count past ``tol / 2`` within 1.5x
    (plus 5)."""
    qc, qp = (np.quantile(x.numpy(), [0.99, 0.999]) for x in (card64, cpu64))
    past = [int((x > tol / 2).sum()) for x in (card64, cpu64)]
    say(f"{what}: distance of float32 to float64 over {len(card64)} "
          f"envs (99th/99.9th percentile/max): card "
          f"{_quantiles(card64)}, CPU {_quantiles(cpu64)}; past {tol / 2:g}: "
          f"card {past[0]}, CPU {past[1]}")
    _check(bool((qc <= 2 * qp + 1e-6).all()),
           f"{what}: the card's float32 steps are farther from float64 than the CPU's")
    _check(past[0] <= 1.5 * past[1] + 5,
           f"{what}: more of the card's float32 steps past {tol / 2:g} of float64")


def phase_spd_solve(device: str, n: int, nv: int, dtype=None) -> None:
    """The physics' batched SPD solve alone at ``[n, nv, nv]`` in the
    physics' dtype (float32 unless the model steps in float64): its
    launches and device time per call, and its residual on random SPD
    matrices."""
    import torch

    from envpool_tpu_torch.physics.linalg import spd_solve

    dtype = dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = torch.randn(n, nv, nv, generator=gen, device=device, dtype=dtype)
    M = a @ a.transpose(1, 2) + torch.eye(nv, device=device, dtype=dtype)
    b = torch.randn(n, nv, generator=gen, device=device, dtype=dtype)
    x = spd_solve(M, b)
    res = float(((M @ x[..., None])[..., 0] - b).abs().max())
    _check(res < 1e-3, f"spd_solve residual {res}")
    ms = _time_ms(lambda: spd_solve(M, b))
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        spd_solve(M, b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = sorted({e.key[:40] for e in _device_events(events)})
    print(f"spd_solve at ({n}, {nv}, {nv}) {str(dtype).removeprefix('torch.')}: "
          f"{ms:.4f} ms per call, "
          f"{_launches(events)} kernel launches ({'; '.join(names)}); max "
          f"residual {res:.3g}")


def section_pong(device: str, card: str) -> tuple[dict, int]:
    """K1 against its plain version and PongLite-v5 at ``N_ENVS`` envs
    through every phase; returns K1's record and its launches on the
    PongLite-v5 path."""
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize

    stats = phase_kernel_vs_plain(device, N_ENVS)
    fused_pool_resize.launches = 0
    phase_adapters(device, N_ENVS)
    k1_launches = fused_pool_resize.launches
    _check(k1_launches > 0, "the PongLite-v5 path never launched K1")
    print(f"K1 launches on the PongLite-v5 path: {k1_launches}")
    # 30 steps, to leave the script's time to the physics phases
    phase_card_vs_cpu(device, "PongLite-v5", 8, 30, max_episode_steps=150)
    phase_profile(device, "PongLite-v5", N_ENVS, PROFILE_STEPS, warmup=4)
    # The rollouts of PongLite-v5 (32 steps) and CartPole-v1 (512) are
    # shorter than bench.py's, to leave the script's time to the physics.
    pong_steps = 32
    steps_per_s, k1_run = phase_throughput(device, "PongLite-v5", N_ENVS, pong_steps)
    # one launch for the reset, then one per branch of every step
    per_step = (k1_run - 1) / pong_steps
    _check(per_step == 2, f"K1 launches per env step {per_step}, expected 2")
    print(f"K1 launches per env step: {per_step:g} (step branch + reset branch)")
    print(
        f"PongLite-v5 functional rollout, {N_ENVS} envs x {pong_steps} steps: "
        f"{steps_per_s:,.0f} env-steps/s = {steps_per_s * 4:,.0f} frames/s "
        f"(frame_skip 4) on {card}"
    )
    return stats, k1_launches


def section_machine(device: str, card: str) -> tuple[dict, int]:
    """K2 against its plain version and timed, and Machine2600-v0 at
    ``N_MACHINES`` envs through every phase; returns K2's record and its
    launches on the Machine2600-v0 path."""
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.tools.k2_probe import carts

    k2_err = phase_k2_vs_plain(device)
    k2_stats = phase_k2_timing(device, N_MACHINES, 4 * N_MACHINES)
    k2_stats["max_abs_err"] = max(k2_err, k2_stats["max_abs_err"])
    rom_path = _write_cart(carts().pong_rom())
    machine = dict(rom_path=rom_path, **MACHINE)
    machine_frame.launches = 0
    fused_pool_resize.launches = 0
    k2_per_step = phase_machine_adapters(device, N_MACHINES, rom_path)
    k2_launches = machine_frame.launches
    k1_machine = fused_pool_resize.launches
    _check(k2_launches > 0, "the Machine2600 path never launched K2")
    _check(k1_machine > 0, "the Machine2600 path never launched K1")
    # frame_skip 4 + noop_max 30 + the fire tick: the reset branch runs for
    # every env on every step, as in the JAX engine.
    _check(k2_per_step == 35, f"K2 launches per env step {k2_per_step}, expected 35")
    print(f"K2 launches on the Machine2600 path: {k2_launches} "
          f"({k2_per_step:g} per env step); K1 launches there: {k1_machine}")
    # 44 envs: K2 runs blocks of 8 machines (two warps of 4), so five full
    # blocks and a sixth with 4.  Env 0 holds DOWN and loses its life.
    phase_card_vs_cpu(device, "Machine2600-v0", 44, 12, hold=5, frame_skip=1,
                      noop_max=1, use_fire_reset=False, **machine)
    phase_profile(device, "Machine2600-v0", N_MACHINES, PROFILE_STEPS, warmup=1,
                  kernel="machine_frame_kernel", **machine)
    machine_steps, k1_run = phase_throughput(
        device, "Machine2600-v0", N_MACHINES, 16, **machine)
    k1_per_step = (k1_run - 1) / 16
    _check(k1_per_step == 2, f"K1 launches per Machine2600 step {k1_per_step}, expected 2")
    print(
        f"Machine2600-v0 functional rollout, {N_MACHINES} envs x 16 steps: "
        f"{machine_steps:,.1f} env-steps/s = {machine_steps * 35:,.0f} emulated "
        f"frames/s (35 per env step) on {card}"
    )
    return k2_stats, k2_launches


# ---------------------------------------------------------------------------
# The constraint solver's PGS kernel
# ---------------------------------------------------------------------------

# Kernel against plain: float32 within 1e-4 · (1 + |plain|) (the kernel
# forms A from L⁻¹J, keeps running residuals and multiplies by 1 / diag,
# where the plain route solves with M⁻¹Jᵀ, sums each row's dot product
# and divides: float32 rounding of forces up to ~1e4, as
# tests/test_torch_solver.py holds the plain route to JAX's), float64
# within 1e-10 · (1 + |plain|).
PGS_TOL = {"float32": 1e-4, "float64": 1e-10}
PGS_ITERS = 40
# Random systems: (rows, dofs, dtypes, active share, systems).  Ant's
# widths; 400 rows at half active, past what an env keeps resident (the
# device-memory path); the dog's 79 dofs in float64.
PGS_RANDOM = ((108, 14, ("float32", "float64"), 0.1, 256),
              (400, 14, ("float32", "float64"), 0.5, 256),
              (200, 79, ("float64",), 0.5, 64))
# Every NOT_SPD-th env of the NaN batch gets an M that is not SPD.
NOT_SPD = 7


def _random_pgs(n: int, nr: int, nv: int, dtype, device, share: float, not_spd: int = 0):
    """``n`` random constraint systems of ``nr`` rows over ``nv`` dofs
    (a random SPD ``M``, or one that is not in every ``not_spd``-th env),
    about ``share`` of the rows active: ``pgs_solve``'s arguments."""
    import torch

    from envpool_tpu_torch.physics.linalg import spd_factor

    gen = torch.Generator(device=device).manual_seed(SEED + nr + nv)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=torch.float64)

    B = randn(n, nv, nv)
    M = B @ B.transpose(1, 2) + nv * torch.eye(nv, device=device, dtype=torch.float64)
    if not_spd:
        M[::not_spd] = -M[::not_spd]
    J, qacc, aref = randn(n, nr, nv), randn(n, nv), randn(n, nr)
    R = 0.1 + torch.rand(n, nr, generator=gen, device=device, dtype=torch.float64)
    active = torch.rand(n, nr, generator=gen, device=device) < share
    L, ok = spd_factor(M.to(dtype))
    J, qacc, aref, R = (t.to(dtype) for t in (J, qacc, aref, R))
    return [J, L, ok, qacc, aref, R, active]


def _ant_pgs(device: str, n: int, steps: int):
    """``pgs_solve``'s arguments from Ant-v4's solver at ``n`` envs on
    ``device``: the state ``steps`` random env steps after a reset, at the
    model's timestep."""
    import torch

    from envpool_tpu_torch.physics import dynamics, solver

    pool = _pool(device, "Ant-v4", n, contact_solver="mujoco")
    eng, env = pool.engine, pool.engine.env
    gen = torch.Generator(device=device).manual_seed(SEED)
    sample = _sampler(_spec(pool), n, device)
    ps, _ = eng.reset(pool.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(steps):
        ps, _ = eng.step(ps, {"action": sample(gen)})
    q, qd = ps.env_state["qpos"], ps.env_state["qvel"]
    with dynamics.full_fp32():
        M, tau, _, k = dynamics._smooth(env.model, q, qd, sample(gen), env.contact)
        return list(solver.pgs_system(env.model, k, q, qd, M, tau, env.model.timestep))


def _pgs_err(got, want) -> float:
    """The largest ``|kernel − plain| / (1 + |plain|)`` over ``f`` and
    ``qfrc``."""
    return max(float(((g - w).abs() / (1 + w.abs())).max()) for g, w in zip(got, want))


def _device_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: the calls are queued behind a sleep on
    the card, so the host's time to enqueue them does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)  # ~10 ms at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _chain_ns(kind: str, dtype) -> tuple[float, float]:
    """``(ns, SM clocks)`` of one dependent step of a one-warp chain
    (``PgsSolve.chase``'s ``kind``)."""
    import torch

    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    iters = 1 << 16
    pgs_solve.chase(iters, kind, dtype)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = pgs_solve.chase(iters, kind, dtype)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e6 / iters, int(out[0]) / iters


def phase_pgs_vs_plain(device: str, n_ant: int) -> dict:
    """The PGS kernel against its plain version on the card: random
    systems (``PGS_RANDOM``: float32 and float64 at Ant's widths, past
    what an env keeps resident, the dog's dofs in float64), a batch with
    some ``M`` not SPD (NaN there and only there), and Ant-v4's own rows
    at ``n_ant`` envs; there the occupancy and waves the runtime reports,
    its time against the plain version's, the formation's PyTorch calls
    (``library_ms``) and its bounds (chain: the most active rows of one
    env x 40 sweeps x one dependent FMA and max, measured here; bytes);
    returns the kernel's record."""
    import torch

    from envpool_tpu_torch.ops.cuda_pgs import pgs_form, pgs_solve, pgs_solve_plain

    max_err = 0.0
    resident = {dt: pgs_solve.occupancy(1, 14, dt)["resident_rows"]
                for dt in (torch.float32, torch.float64)}

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def versus(sys_, name, what):
        got = pgs_solve(*sys_, PGS_ITERS)
        start.record()
        want = pgs_solve_plain(*sys_, PGS_ITERS)
        end.record()
        torch.cuda.synchronize()
        ok, active = sys_[2], sys_[6]
        err = _pgs_err([g[ok] for g in got], [w[ok] for w in want])
        _check(err <= PGS_TOL[name], f"the PGS kernel disagrees with plain ({what}): {err:.3g}")
        _check(bool((got[0].masked_fill(active, 0) == 0).all()), f"inactive rows got a force ({what})")
        _check(bool(torch.isfinite(got[1][ok]).all()), f"the PGS kernel is not finite ({what})")
        return got, want, err, start.elapsed_time(end)

    for nr, nv, names, share, n in PGS_RANDOM:
        for name in names:
            dtype = getattr(torch, name)
            sys_ = _random_pgs(n, nr, nv, dtype, device, share)
            err = versus(sys_, name, f"{name}, {nr} rows, {nv} dofs")[2]
            na = sys_[6].sum(1)
            print(f"PGS vs plain [{name}, {n} random systems of {nr} rows over {nv} dofs, "
                  f"{int(na.min())}-{int(na.max())} active, {resident[dtype]} resident]: "
                  f"max |kernel - plain| / (1 + |plain|) over f and qfrc = {err:.3g} "
                  f"(tolerance {PGS_TOL[name]:g})")
            if dtype == torch.float32:
                max_err = max(max_err, err)
    sys_ = _random_pgs(64, 108, 14, torch.float32, device, 0.3, not_spd=NOT_SPD)
    got, want, err, _ = versus(sys_, "float32", "M not SPD in some envs")
    bad, active = ~sys_[2], sys_[6]
    want_bad = torch.zeros_like(bad)
    want_bad[::NOT_SPD] = True
    _check(torch.equal(bad, want_bad), "cholesky_ex flagged other envs than the ones not SPD")
    for which, out in (("kernel", got), ("plain", want)):
        _check(torch.equal(out[1].isnan().any(1), bad) and bool(out[1][bad].isnan().all()),
               f"the {which}'s qfrc is not NaN exactly on the envs whose M is not SPD")
        _check(torch.equal(out[0].isnan(), active & bad[:, None]),
               f"the {which}'s forces are not NaN exactly on those envs' active rows")
    print(f"PGS with M not SPD in {int(bad.sum())} of 64 envs: qfrc NaN on those envs and "
          f"only there, their active rows' forces NaN, inactive rows 0, kernel and plain "
          f"alike; the others within {err:.3g}")
    max_err = max(max_err, err)

    sys_ = _ant_pgs(device, n_ant, 10)
    got, want, err, plain_ms = versus(sys_, "float32", "Ant-v4's rows")
    max_err = max(max_err, err)
    # Both float32 routes against the plain route in float64: how far each
    # lies from the forces float32 rounding blurs.
    ref = pgs_solve_plain(*(t.double() if t.is_floating_point() else t for t in sys_),
                          PGS_ITERS)
    to64 = [_pgs_err([g.double() for g in out], ref) for out in (got, want)]
    J, L, ok, qacc, aref, R, active = sys_
    n, nr, nv = J.shape
    na = active.sum(1)
    warps_past = int((na.view(-1, 4).max(1).values > resident[J.dtype]).sum())
    occ = pgs_solve.occupancy(n, nv, J.dtype)
    print(f"PGS vs plain [Ant-v4's rows at {n} envs, {nr} rows over {nv} dofs, "
          f"{int(na.min())}-{int(na.max())} active, mean {float(na.float().mean()):.2f}; "
          f"{warps_past} of {n // 4} warps past {resident[J.dtype]} resident rows]: "
          f"max |kernel - plain| / (1 + |plain|) = {err:.3g}; against the plain route in "
          f"float64: kernel {to64[0]:.3g}, plain {to64[1]:.3g}")
    print(f"PGS occupancy at Ant-v4's {n} envs: {occ['blocks_per_sm']} blocks of 16 envs per "
          f"SM ({occ['envs_per_sm']} envs, {occ['smem_per_block']} B shared memory a block) "
          f"on {occ['sms']} SMs: {occ['waves']} wave(s)")
    _check(occ["waves"] == 1, f"the PGS kernel takes {occ['waves']} waves at Ant's {n} envs")
    before = pgs_solve.launches
    ms = _device_ms(lambda: pgs_solve(*sys_, PGS_ITERS))
    pgs_solve.launches = before

    def formation():
        # The PyTorch calls that the kernel's formation replaces: the plain
        # route's own formation (M^-1 J^T by cholesky_solve with nr
        # columns, A = J M^-1 J^T, b, diag), then J^T f.
        pgs_form(J, L, ok, qacc, aref, R)
        return (J.transpose(1, 2) @ want[0][..., None]).squeeze(-1)

    library_ms = _device_ms(formation)
    step_ns, step_clk = _chain_ns("fma_max", torch.float32)
    sum_ns, sum_clk = _chain_ns("warp_sum", torch.float32)
    most = int(na.max())
    chain_ms = most * PGS_ITERS * step_ns * 1e-6
    rows = int(na.sum())
    size = J.element_size()
    # L counts its lower triangle: the zeros above its diagonal are not
    # input the function needs.
    nbytes = (rows * (nv + 2) * size + n * (nv * (nv + 1) // 2 + nv) * size + n * nr + n
              + n * (nr + nv) * size)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"dependent float32 FMA + max (one warp's chain): {step_clk:.1f} SM clocks = "
          f"{step_ns:.2f} ns; the step of a kernel with one warp per env, a dependent "
          f"warp-wide float32 sum: {sum_clk:.1f} SM clocks = {sum_ns:.2f} ns")
    print(f"PGS timing at Ant's rows, {n} envs (formation, sweeps and J^T f): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms, library (formation only: cholesky_solve of "
          f"J^T, J M^-1 J^T, b, diag, J^T f) {library_ms:.4f} ms; bounds: chain {most} rows "
          f"x {PGS_ITERS} sweeps x {step_ns:.2f} ns = {chain_ms:.5f} ms (at the warp-sum "
          f"step: {most * PGS_ITERS * sum_ns * 1e-6:.5f} ms), bytes {nbytes / 1e6:.3f} MB "
          f"(J, aref, R of the {rows} active rows, L's lower triangle, qacc_smooth, active, "
          f"ok in; f, qfrc out) / 3.35 TB/s = {bytes_ms:.5f} ms; the kernel reaches "
          f"{max(chain_ms, bytes_ms) / ms:.4f} of its bound")
    return {
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(chain_ms, bytes_ms),
        "bound_by": "operations" if chain_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


def phase_bank_reset(device: str, task: str, n: int) -> None:
    """``n`` resets of ``task`` on the card and on the CPU from one seed:
    the same states bit for bit (CheetahRun gathers rows of its committed
    bank on either device)."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core.engine import Engine

    states = []
    for dev in (device, "cpu"):
        eng = Engine(envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED, device=dev).env)
        ps, _ = eng.reset(eng.init(), torch.ones(n, dtype=torch.bool, device=dev))
        states.append([ps.env_state[k].cpu() for k in ("qpos", "qvel")])
    _check(all(torch.equal(a, b) for a, b in zip(*states)),
           f"{task}'s resets differ between the card and the CPU")
    print(f"{task}: {n} resets from seed {SEED} on the card and on the CPU give the "
          f"same states bit for bit")


def phase_drop_reset(device: str, task: str, n: int) -> None:
    """``n`` resets of a quadruped task on the card and on the CPU from one
    seed: the same start states, the torso's height (the drop height, on a
    1 cm grid) equal except where the clearance lies within 1e-6 of a cell
    of a grid line, everything else within 1e-6 · (1 + |x|) (the
    orientation is a normalised normal draw, whose log and cos may differ
    by an ulp between the devices)."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core.engine import Engine

    states = []
    for dev in (device, "cpu"):
        eng = Engine(envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED, device=dev).env)
        ps, _ = eng.reset(eng.init(), torch.ones(n, dtype=torch.bool, device=dev))
        states.append(torch.cat([ps.env_state[k].cpu() for k in ("qpos", "qvel")], 1))
    card, cpu = states
    cells = eng.env.clearance_cells(cpu[:, :eng.env.model.nq])
    at_line = (cells - cells.round()).abs() < 1e-6
    z_differ = card[:, 2] != cpu[:, 2]
    err = float(_rel(torch.cat([card[:, :2], card[:, 3:]], 1),
                     torch.cat([cpu[:, :2], cpu[:, 3:]], 1)).max())
    _check(not bool((z_differ & ~at_line).any()),
           f"{task}: {int((z_differ & ~at_line).sum())} resets' drop heights differ "
           "between the card and the CPU away from a grid line")
    _check(err <= 1e-6, f"{task}: resets differ by {err:.3g} between the card and the CPU")
    print(f"{task}: {n} resets from seed {SEED} on the card and on the CPU: drop "
          f"heights equal in {int((~z_differ).sum())} ({int(at_line.sum())} within 1e-6 "
          f"of a grid line), the rest of the states within {err:.3g}")


def phase_physics(device: str, card: str, task: str, n: int, episode: int,
                  tol: float, rollout_steps: int, vs_n: int | None = None,
                  **make_kwargs) -> dict:
    """CartPole-v1, FrozenLake8x8-v1 or a physics task at ``n`` envs
    through every entry point, card vs CPU (at ``vs_n`` envs, where the
    CPU's side would not fit the script's time at ``n``), a profile, for the physics the batched SPD solve at the
    model's ``nv`` and dtype, and a functional rollout, each with
    ``make_kwargs``; none of it may launch K1 or K2, and only the
    constraint solver (``contact_solver="mujoco"``) the PGS kernel.
    Returns the profile's numbers and the PGS kernel's launches."""
    import envpool_tpu_torch
    from envpool_tpu_torch.envs.physics_env import PhysicsEnv
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    t0 = time.perf_counter()
    machine_frame.launches = 0
    fused_pool_resize.launches = 0
    pgs_solve.launches = 0
    env = envpool_tpu_torch.make_spec(task, device="cpu", **make_kwargs).env
    physics = isinstance(env, PhysicsEnv)
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    seen = phase_float_adapters(device, task, n, episode, dm_episode=_is_dmc(task),
                                **make_kwargs)
    _check(task not in ("CartPole-v1", "FrozenLake8x8-v1") or seen["terminated"] > 0,
           f"no {task} termination")
    _check(task not in ("HalfCheetah-v4", "CheetahRun-v1", "DogRun-v1")
           or (seen["terminated"], seen["truncated"]) == (0, n),
           f"{task} ends its episodes by truncation alone")
    if task == "CheetahRun-v1":
        phase_bank_reset(device, task, n)
    if task.startswith("Quadruped"):
        phase_drop_reset(device, task, n)
    lap("adapters")
    vs = phase_float_card_vs_cpu(device, task, vs_n or n, warmup=30, steps=3, tol=tol,
                                 spread=_spread(task), **make_kwargs)
    check_shares(task, vs)
    if physics:
        check_f64_parity(f"{task} state", vs["card"], vs["cpu"], tol)
        check_f64_parity(f"{task} obs", vs["card_obs"], vs["cpu_obs"], tol)
    lap("card vs CPU")
    prof = phase_profile(device, task, n, PROFILE_STEPS, warmup=2, **make_kwargs)
    if physics:
        phase_spd_solve(device, n, env.model.nv, env.physics_dtype)
    lap("profile")
    task_steps, _ = phase_throughput(device, task, n, rollout_steps, **make_kwargs)
    lap("rollout")
    _check(fused_pool_resize.launches == machine_frame.launches == 0,
           f"{task} launched K1 or K2")
    solver = make_kwargs.get("contact_solver") == "mujoco"
    _check((pgs_solve.launches > 0) == solver,
           f"{task}{_kw(make_kwargs)} launched the PGS kernel {pgs_solve.launches} times")
    print(
        f"{task}{_kw(make_kwargs)} at {n} envs on {card}: functional rollout of {rollout_steps} "
        f"steps {task_steps:,.0f} env-steps/s; engine step {prof['launches']:.0f} "
        f"kernel launches, {prof['said']}; K1 and K2 launched 0 times, the PGS kernel "
        f"{pgs_solve.launches} ({time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")"
    )
    return dict(prof, pgs_launches=pgs_solve.launches, steps_per_s=task_steps)


def _kw(make_kwargs: dict) -> str:
    """`` (key=value, ...)`` of a phase's make arguments, or nothing."""
    return f" ({', '.join(f'{k}={v!r}' for k, v in make_kwargs.items())})" if make_kwargs else ""


def section_solver(device: str, card: str, later: CpuSide) -> tuple[dict, int]:
    """The PGS kernel against its plain version and timed, then Ant-v4 with
    the constraint solver at ``N_ANT`` envs through every phase (card vs
    CPU at ``N_SOLVER_VS``), and short checks of CheetahRun-v1 and of a
    float64 model in solver mode (their CPU's side in ``later``'s worker);
    returns the kernel's record and its launches on the Ant-v4 path."""
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    stats = phase_pgs_vs_plain(device, N_ANT)
    prof = phase_physics(device, card, "Ant-v4", N_ANT, 10, PHYSICS_TOL, SOLVER_ROLLOUT,
                         vs_n=N_SOLVER_VS, contact_solver="mujoco")
    launches = prof["pgs_launches"]
    # one solve per substep (Euler, Ant-v4's registered integrator) or per
    # RK4 stage, none in the reset branch
    pool = _pool(device, "Ant-v4", N_SHORT, contact_solver="mujoco")
    env = pool.engine.env
    want = env.frame_skip * env.substeps * (4 if env.model.integrator == 1 else 1)
    ps, _ = pool.engine.reset(pool.pool_state, pool.pool_state.autoreset)
    before = pgs_solve.launches
    pool.engine.step(ps, pool.engine.zero_action())
    per_step = pgs_solve.launches - before
    _check(per_step == want, f"PGS launches per Ant-v4 env step {per_step}, expected {want}")
    print(f"PGS kernel launches on the Ant-v4 solver path: {launches} ({per_step} per env "
          f"step: one per substep of frame skip {env.frame_skip}); profile: "
          f"{prof['launches']:.0f} launches, "
          f"{prof['said']} per env step; rollout of {SOLVER_ROLLOUT} steps "
          f"{prof['steps_per_s']:,.0f} env-steps/s on {card}")
    phase_short_checks(device, "dm_control solver", list(SOLVER_SHORT), later,
                       contact_solver="mujoco")
    return stats, launches


def phase_pixels_card_vs_cpu(device: str, task: str, n: int, warmup: int, steps: int) -> None:
    """After ``warmup`` random steps of ``task`` from pixels on the card,
    ``steps`` engine steps, each checked: the frame stack rolled (or, for an
    env that reset, holds its first frame in every slot), and the newest
    frame equals the CPU's render of the card's new state under the frame
    rule (``ops.rasterize.frame_rule_violations``: pixels that float
    rounding decides, marked by a float64 render, may differ, at most
    ``MAX_PIXEL_DIFFER`` of them)."""
    import torch

    from envpool_tpu_torch.ops import rasterize

    # episodes of warmup + 1 steps: the last checked step resets every env
    pool = _pool(device, task, n, from_pixels=True, max_episode_steps=warmup + 1)
    eng, env = pool.engine, pool.engine.env
    gen = torch.Generator(device=device).manual_seed(SEED)
    sample = _sampler(_spec(pool), n, device)
    ps, _ = eng.reset(pool.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(warmup):
        ps, _ = eng.step(ps, {"action": sample(gen)})
    totals = dict.fromkeys(("pixels", "differ", "at_edge", "at_trunc", "violations"), 0)
    worst, resets, t0 = 0, 0, time.perf_counter()
    for t in range(steps):
        before = ps.env_state["frames"]
        ps, ts = eng.step(ps, {"action": sample(gen)})
        frames = ps.env_state["frames"]
        _check(torch.equal(ts["obs"], frames), "the obs is not the frame stack")
        first = ts["step_type"] == 0
        resets += int(first.sum())
        rolled = torch.where(first[:, None, None, None], frames[:, -1:].expand_as(frames),
                             torch.cat([before[:, 1:], frames[:, -1:]], 1))
        _check(torch.equal(frames, rolled), f"{task}: the frame stack did not roll at step {t}")
        qpos = ps.env_state["inner"]["qpos"]
        want = env.frame(qpos.cpu())  # the CPU's render
        edge, trunc = (x.cpu() for x in rasterize.rounding_pixels(
            env.inner.model, qpos, env.height, env.width, env.track_body, env.view_size))
        v = rasterize.frame_rule_violations(frames[:, -1].cpu(), want, edge, trunc)
        for k in totals:
            totals[k] += v[k]
        worst = max(worst, v["max_diff"])
        _check(v["violations"] == 0, f"{task}: frames break the frame rule at step {t}: {v}")
    _check(totals["differ"] <= MAX_PIXEL_DIFFER * totals["pixels"],
           f"{task}: {totals['differ']} of {totals['pixels']} pixels differ")
    _check(resets > 0, f"{task}: no reset among the checked steps")
    print(f"{task} from pixels card vs CPU, {n} envs x {steps} steps (after {warmup} warm-up "
          f"steps; {resets} resets): the newest frame against the CPU's render of the card's "
          f"state: {totals['differ']} of {totals['pixels']} pixels differ ({totals['at_edge']} "
          f"at an edge, {totals['at_trunc']} at a truncation, largest {worst}), 0 against the "
          f"rule; the stack rolled ({time.perf_counter() - t0:.1f} s)")


def section_pixels(device: str, card: str) -> dict:
    """CheetahRun-v1 from pixels at ``N_DMC`` envs through every entry
    point, card vs CPU on the frames, a profile and a rollout; none of it
    may launch K1, K2 or the PGS kernel.  Returns the profile's numbers."""
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    t0 = time.perf_counter()
    task = "CheetahRun-v1"
    machine_frame.launches = fused_pool_resize.launches = pgs_solve.launches = 0
    seen = phase_float_adapters(device, task, N_DMC, 10, dm_episode=True, from_pixels=True)
    _check((seen["terminated"], seen["truncated"]) == (0, N_DMC),
           f"{task} ends its episodes by truncation alone")
    t1 = time.perf_counter()
    phase_pixels_card_vs_cpu(device, task, N_DMC, warmup=8, steps=2)
    t2 = time.perf_counter()
    prof = phase_profile(device, task, N_DMC, PROFILE_STEPS, warmup=2, from_pixels=True)
    t3 = time.perf_counter()
    steps_per_s, _ = phase_throughput(device, task, N_DMC, PIXEL_ROLLOUT, from_pixels=True)
    _check(fused_pool_resize.launches == machine_frame.launches == pgs_solve.launches == 0,
           f"{task} from pixels launched K1, K2 or the PGS kernel")
    print(f"{task} from pixels at {N_DMC} envs on {card}: functional rollout of "
          f"{PIXEL_ROLLOUT} steps {steps_per_s:,.0f} env-steps/s; engine step "
          f"{prof['launches']:.0f} kernel launches, {prof['said']}; K1, K2 and the PGS kernel "
          f"launched 0 times "
          f"({time.perf_counter() - t0:.1f} s: adapters {t1 - t0:.1f}, card vs CPU "
          f"{t2 - t1:.1f}, profile {t3 - t2:.1f}, rollout {time.perf_counter() - t3:.1f})")
    return dict(prof, steps_per_s=steps_per_s)


# ---------------------------------------------------------------------------
# procgen (MazeEasy-v0) and vizdoom (Basic-v1): no kernel on their paths
# ---------------------------------------------------------------------------

# The widths of bench.py's sweep rows (bench.py:203, :204); every other id
# of the two families a short card-vs-CPU check (procgen's grid ids exact,
# at N_EXACT envs, the others by the rule at N_RENDER_SHORT envs).
N_MAZE = 2048
N_DOOM = 1024
N_RENDER_SHORT = 64
GRID_GAMES = ("Maze", "Heist", "Chaser", "Miner")


def _kernel_launches() -> tuple:
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    return fused_pool_resize, machine_frame, pgs_solve


def phase_rule_card_vs_cpu(device: str, task: str, n: int, warmup: int, steps: int,
                           tol: float | None = None, policy=None, reached=None,
                           **make_kwargs) -> dict:
    """After ``warmup`` steps on the card, ``steps`` engine steps each
    taken on the card and on the CPU from the same pool state and action,
    held by ``ops.thresholds.hold_step``: every field but the frames
    within ``tol`` (``STATE_TOL`` by default; 0: equal) of the CPU's, an
    env near a float threshold excused (at most ``MAX_EXCUSED_SHARE`` of
    the env steps), frames equal but at pixels float rounding decides (at
    most ``MAX_PIXEL_SHARE`` of them differ), with resets among the
    checked steps.  The card's steps run under a caller that allows TF32,
    which the engine must not let into the env's matmuls.  The actions are
    uniform at random, or ``policy(env_state, generator)``'s; with
    ``reached = (what, fn)``, ``fn(timestep, env_state)`` on the CPU's side
    of a checked step must hold for some env (a mechanism that the checked
    steps must reach).  Returns the totals."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core import rng
    from envpool_tpu_torch.core.engine import Engine, PoolState, _tree_map
    from envpool_tpu_torch.ops import thresholds

    tol = thresholds.STATE_TOL if tol is None else tol
    card = _pool(device, task, n, **make_kwargs)
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED, device="cpu",
                                      **make_kwargs).env
    cpu = Engine(env)
    eng = card.engine
    gen = torch.Generator().manual_seed(SEED)
    sample = _sampler(_spec(card), n, "cpu", env.max_num_players)
    act_for = (lambda st: sample(gen)) if policy is None else (lambda st: policy(st, gen))
    matmul = torch.backends.cuda.matmul

    def card_step(ps, act):
        matmul.fp32_precision = "tf32"  # a caller that allows TF32
        try:
            ps, ts = eng.step(ps, {"action": act.to(device)})
            _check(matmul.fp32_precision == "tf32",
                   f"{task}: the engine did not restore the caller's TF32 setting")
        finally:
            matmul.fp32_precision = "ieee"
        return ps, ts

    ps, _ = eng.reset(card.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(warmup):
        ps, _ = card_step(ps, act_for(ps.env_state))
    totals, resets, hits, t0 = {}, 0, 0, time.perf_counter()
    for t in range(steps):
        ps_cpu = PoolState(*(_tree_map(lambda x: x.cpu(), f) for f in (
            ps.env_state, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)))
        act = act_for(ps_cpu.env_state)
        ps, got = card_step(ps, act)
        cps, want = cpu.step(ps_cpu, {"action": act})
        draws = env.step_draws(rng.split(ps_cpu.key)[1])
        v = thresholds.hold_step(
            env, ps_cpu.env_state, act, draws, ps_cpu.autoreset,
            {"state": cps.env_state, "ts": want},
            {"state": _tree_map(lambda x: x.cpu(), ps.env_state),
             "ts": {k: x.cpu() for k, x in got.items()}}, tol)
        _check(v["failed"] == 0 and v["violations"] == 0,
               f"{task}: card and CPU differ at step {t}: {v}")
        for k, x in v.items():
            totals[k] = totals.get(k, 0) + x
        resets += int(ps_cpu.autoreset.sum())
        if reached is not None:
            hits += int(reached[1](want, cps.env_state).sum())
    _check(totals["excused"] <= thresholds.MAX_EXCUSED_SHARE * totals["envs"],
           f"{task}: {totals['excused']} of {totals['envs']} env steps excused")
    _check(totals["differ"] <= thresholds.MAX_PIXEL_SHARE * totals["pixels"],
           f"{task}: {totals['differ']} of {totals['pixels']} pixels differ")
    _check(resets > 0, f"{task}: no reset among the checked steps")
    _check(reached is None or hits > 0, f"{task}: no env {reached and reached[0]} "
           "in the checked steps")
    print(f"  {task} card vs CPU, {n} envs x {steps} steps from the same states (after "
          f"{warmup} warm-up steps; {resets} resets"
          + (f"; {hits} env steps {reached[0]}" if reached else "") + "; the caller allowing "
          "TF32): fields " + ("equal" if tol == 0 else f"within {tol:g}")
          + f", {totals['excused']} env steps "
          f"excused near a threshold; {totals['differ']} of {totals['pixels']} pixels differ "
          f"({totals['at_edge']} where a nudge flips them, {totals['at_trunc']} at a "
          f"rounding tie), 0 against the rule ({time.perf_counter() - t0:.1f} s)")
    return totals


def phase_profile_reset(device: str, task: str, n: int, calls: int = PROFILE_RESETS) -> dict:
    """``torch.profiler`` over ``calls`` runs of the env's reset branch
    alone (its draws and ``reset_env`` for every row, which the engine
    runs on every step): launches and device ms per run.  The device ms
    stand only where the profiler kept one device record for each kernel
    launched (late in a long process it has kept none of a window of a few
    launches); else ``device_ms`` is None, and ``said`` tells it."""
    import torch

    from envpool_tpu_torch.core import rng

    env = _pool(device, task, n).engine.env
    sub = rng.split(env.keys())[1]
    env.reset_env(env.reset_draws(sub))  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            env.reset_env(env.reset_draws(sub))
        torch.cuda.synchronize()
    events = prof.key_averages()
    seen = _device_events(events)
    launched = _launches(events)
    kept = sum(e.count for e in seen if not e.key.startswith(("Memcpy", "Memset")))
    device_ms = (sum(e.self_device_time_total for e in seen) / calls / 1e3
                 if kept == launched else None)
    said = (f"{device_ms:.3f} device ms" if device_ms is not None else
            f"device ms not measured (the profiler kept {kept} of {launched} kernels)")
    print(f"profile, {task} reset branch alone at {n} envs: {launched / calls:.0f} kernel "
          f"launches, {said} per step")
    return {"launches": launched / calls, "device_ms": device_ms, "said": said}


def section_render(device: str, card: str, task: str, n: int, episode: int,
                   rollout_steps: int, vs_n: int, tol: float | None,
                   exact_state: bool = False, legal: bool = False, warmup: int = 30,
                   policy=None, reached=None) -> dict:
    """``task`` at ``n`` envs through every entry point (the gymnasium
    pool's episodes cut at ``episode`` steps), card vs CPU at ``vs_n`` envs
    after ``warmup`` steps in episodes of ``warmup + 1``
    (:func:`phase_rule_card_vs_cpu`, ``tol`` 0: equal, driven by
    ``policy`` and reaching ``reached`` where given; with
    ``exact_state``, :func:`phase_state_card_vs_cpu`, by legal moves with
    ``legal``), a profile and a
    functional rollout; none of it may launch K1, K2 or the PGS kernel.
    Returns the profile's numbers and the rollout's rate."""
    kernels = _kernel_launches()
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    seen = phase_float_adapters(device, task, n, episode)
    lap("adapters")
    # Episodes of warmup + 1 steps: the checked steps end them, reset, step
    # again.
    if exact_state:
        phase_state_card_vs_cpu(device, task, vs_n, warmup=warmup, steps=3, legal=legal,
                                max_episode_steps=warmup + 1)
    else:
        phase_rule_card_vs_cpu(device, task, vs_n, warmup=warmup, steps=3, tol=tol,
                               policy=policy, reached=reached, max_episode_steps=warmup + 1)
    lap("card vs CPU")
    prof = phase_profile(device, task, n, PROFILE_STEPS, warmup=2)
    reset = phase_profile_reset(device, task, n)
    lap("profile")
    steps_per_s, _ = phase_throughput(device, task, n, rollout_steps)
    lap("rollout")
    _check(all(k.launches == 0 for k in kernels), f"{task} launched K1, K2 or the PGS kernel")
    print(
        f"{task} at {n} envs on {card}: functional rollout of {rollout_steps} steps "
        f"{steps_per_s:,.0f} env-steps/s; engine step {prof['launches']:.0f} kernel launches, "
        f"{prof['said']} (the reset branch "
        f"{reset['launches']:.0f} launches, {reset['said']} of it); {seen}; "
        f"K1, K2 and the PGS kernel launched 0 times ({time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return dict(prof, steps_per_s=steps_per_s, reset_launches=reset["launches"],
                reset_device_ms=reset["device_ms"])


def phase_rule_checks(device: str, family: str, tasks: list[str], warmup: int = 8) -> None:
    """A short card-vs-CPU check of each float id of a family by the rule,
    at ``N_RENDER_SHORT`` envs: 3 checked steps after ``warmup`` warm-up
    steps in episodes of ``warmup + 1`` (the last step of an episode, a
    reset, a first step); none may launch K1, K2 or the PGS kernel."""
    kernels = _kernel_launches()
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    excused = differ = 0
    for task in tasks:
        v = phase_rule_card_vs_cpu(device, task, N_RENDER_SHORT, warmup=warmup, steps=3,
                                   max_episode_steps=warmup + 1)
        excused, differ = excused + v["excused"], differ + v["differ"]
    _check(all(k.launches == 0 for k in kernels), f"a {family} id launched K1, K2 or PGS")
    print(f"short card-vs-CPU checks of {len(tasks)} {family} ids by the rule passed "
          f"({excused} env steps excused, {differ} pixels differ in all); K1, K2 and the PGS "
          f"kernel launched 0 times ({time.perf_counter() - t0:.1f} s)")


def section_procgen(device: str, card: str) -> dict:
    """MazeEasy-v0 at ``N_MAZE`` envs (card vs CPU equal in every field),
    the other 13 grid ids exact at ``N_EXACT`` envs, the other 36 ids by
    the rule; returns the main path's numbers."""
    from envpool_tpu_torch.core.registry import registry

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items() if path.endswith(".procgen")]
    stats = section_render(device, card, "MazeEasy-v0", N_MAZE, 15, 128, N_MAZE, 0.0)
    t1 = time.perf_counter()
    grid = [t for t in ids if t.startswith(GRID_GAMES) and t != "MazeEasy-v0"]
    phase_exact_checks(device, [(t, {"max_episode_steps": 8}) for t in grid])
    t2 = time.perf_counter()
    phase_rule_checks(device, "procgen", [t for t in ids if not t.startswith(GRID_GAMES)])
    print(f"procgen: {time.perf_counter() - t0:.1f} s (MazeEasy-v0 {t1 - t0:.1f}, grid ids "
          f"{t2 - t1:.1f}, the other ids {time.perf_counter() - t2:.1f})")
    return stats


def section_vizdoom(device: str, card: str) -> dict:
    """Basic-v1 at ``N_DOOM`` envs (float buttons; card vs CPU at
    ``N_DOOM`` by the rule), every other vizdoom id and Basic-v1 on the
    combined action set by the rule; returns the main path's numbers."""
    from envpool_tpu_torch.core.registry import registry

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items() if path.endswith(".vizdoom")]
    stats = section_render(device, card, "Basic-v1", N_DOOM, 10, 64, N_DOOM, None)
    t1 = time.perf_counter()
    phase_rule_checks(device, "vizdoom", [t for t in ids if t != "Basic-v1"])
    # bench.py's sweep row steps Basic-v1 on the combined action set.
    phase_rule_card_vs_cpu(device, "Basic-v1", N_RENDER_SHORT, warmup=8, steps=3,
                           max_episode_steps=9, use_combined_action=True)
    print(f"vizdoom: {time.perf_counter() - t0:.1f} s (Basic-v1 {t1 - t0:.1f}, the other "
          f"ids {time.perf_counter() - t1:.1f})")
    return stats


# MiniGrid-Empty-8x8-v0 (bench.py:205's width) and BabyAI-BossLevel-v0 at
# N_MINIGRID envs; every other minigrid id exact at N_MINIGRID_SHORT envs
# in episodes of 1 step: from a reset, a checked step that ends every
# episode and one that resets every env.
N_MINIGRID = 8192
N_MINIGRID_SHORT = 64
N_RENDERED = 256


def phase_state_card_vs_cpu(device: str, task: str, n: int, warmup: int, steps: int,
                            legal: bool = False, **make_kwargs) -> dict:
    """After ``warmup`` random steps on the card, ``steps`` engine steps
    each taken on the card and on the CPU from the same pool state and
    action: the new pool state (the env state with it) and the timestep
    equal in every field.  With ``legal``, the actions are drawn from the
    last timestep's legal moves (:func:`_legal_sampler`), so that a board
    game's states go deep.  Returns the resets and terminations seen."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch.core.engine import Engine, PoolState, _tree_map

    card = _pool(device, task, n, **make_kwargs)
    cpu = Engine(envpool_tpu_torch.make_spec(task, num_envs=n, seed=SEED, device="cpu",
                                             **make_kwargs).env)
    eng = card.engine
    gen = torch.Generator().manual_seed(SEED)
    players = eng.env.max_num_players
    if legal:
        draw = _legal_sampler(_spec(card), n, "cpu", players)
    else:
        uniform = _sampler(_spec(card), n, "cpu", players)

        def draw(gen, ts):
            return uniform(gen)
    ps, ts = eng.reset(card.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(warmup):
        ps, ts = eng.step(ps, {"action": draw(gen, ts).to(device)})
    fields = ("env_state", "key", "elapsed", "autoreset", "full_reset")
    resets = terms = 0
    t0 = time.perf_counter()
    for t in range(steps):
        act = draw(gen, ts)
        ps_cpu = PoolState(*(_tree_map(lambda x: x.cpu(), getattr(ps, f)) for f in fields))
        ps, got = eng.step(ps, {"action": act.to(device)})
        cps, want = cpu.step(ps_cpu, {"action": act})
        ts = want
        for f in fields:
            _check(_tree_equal(_tree_map(lambda x: x.cpu(), getattr(ps, f)), getattr(cps, f)),
                   f"{task}: card and CPU differ in {f} at step {t}")
        for k, w in want.items():
            _check(torch.equal(got[k].cpu(), w), f"{task}: card and CPU differ in {k} at "
                   f"step {t}")
        resets += int((want["step_type"] == 0).sum())
        terms += int((want["done"] & ~want["trunc"]).sum())
    print(f"  {task}: card vs CPU, {n} envs x {steps} steps from the same states (after "
          f"{warmup} warm-up steps; {resets} resets, {terms} terminations): state and "
          f"timestep equal in every field ({time.perf_counter() - t0:.1f} s)")
    return {"resets": resets, "terms": terms}


def phase_grid_render(device: str, task: str, n: int, steps: int) -> None:
    """``render()`` of ``N_RENDERED`` envs of a pool stepped ``steps``
    random steps on the card, equal to the CPU's render of the same
    states; the agent's cell is marked."""
    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch import interop

    card = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=SEED,
                                  device=device)
    cpu = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=SEED,
                                 device="cpu")
    card.reset()
    sample = _sampler(_spec(card), n, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(steps):
        card.step(sample(gen).numpy())
    cpu._state = interop.pool_state_from_numpy(interop.pool_state_to_numpy(card.pool_state),
                                               "cpu")
    ids = np.arange(N_RENDERED)
    got, want = card.render(ids), cpu.render(ids)
    _check(got.shape == want.shape == (N_RENDERED, *card._env.render_size, 3)
           and got.dtype == np.uint8, f"{task} render shape {got.shape}")
    _check(bool((got == want).all()), f"{task}: card and CPU frames differ")
    pos = cpu.pool_state.env_state["pos"].numpy()[ids]
    _check(bool((got[ids, pos[:, 1] * 8, pos[:, 0] * 8] == (255, 0, 0)).all()),
           f"{task}: the agent's cell is not marked")
    print(f"{task} render() on the card: {N_RENDERED} of {n} envs, {got.shape} "
          f"{got.dtype}, equal to the CPU's render of the same states")


def build_wfc_banks() -> float:
    """Solve the map bank of every registered WFC id (numpy, cached for the
    process, as each WFC pool asks for it); returns the seconds taken."""
    from envpool_tpu_torch.core.registry import registry
    from envpool_tpu_torch.envs.minigrid import wfc

    t0 = time.perf_counter()
    for _, cls, kwargs in registry.specs.values():
        if cls == "WFCEnv":
            config = dict(wfc.WFCEnv.DEFAULT_CONFIG, **kwargs)
            wfc._map_bank(str(config["wfc_preset"]), int(config["size"]),
                          int(config["bank_size"]))
    return time.perf_counter() - t0


def section_minigrid(device: str, card: str) -> dict:
    """MiniGrid-Empty-8x8-v0 at ``N_MINIGRID`` envs through every entry
    point (card vs CPU equal in every field of the state and the timestep;
    ``render()``), BabyAI-BossLevel-v0 at ``N_MINIGRID`` (a profile of the
    step and of its reset branch alone, a rollout, card vs CPU equal in
    every field), and every other minigrid id exact at
    ``N_MINIGRID_SHORT``; returns the main paths' numbers."""
    from envpool_tpu_torch.core.registry import registry

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items() if path.endswith(".minigrid")]
    empty = section_render(device, card, "MiniGrid-Empty-8x8-v0", N_MINIGRID, 15, 128,
                           N_MINIGRID, 0.0, exact_state=True)
    phase_grid_render(device, "MiniGrid-Empty-8x8-v0", N_MINIGRID, 20)
    t1 = time.perf_counter()
    boss = "BabyAI-BossLevel-v0"
    kernels = _kernel_launches()
    for k in kernels:
        k.launches = 0
    prof = phase_profile(device, boss, N_MINIGRID, PROFILE_STEPS, warmup=2)
    reset = phase_profile_reset(device, boss, N_MINIGRID)
    steps_per_s, _ = phase_throughput(device, boss, N_MINIGRID, 16)
    # Episodes of 2 steps: the second checked step resets every env.
    phase_state_card_vs_cpu(device, boss, N_MINIGRID, 1, 2, max_episode_steps=2)
    phase_grid_render(device, boss, N_RENDERED, 5)
    _check(all(k.launches == 0 for k in kernels), f"{boss} launched K1, K2 or the PGS kernel")
    print(f"{boss} at {N_MINIGRID} envs on {card}: functional rollout of 16 steps "
          f"{steps_per_s:,.0f} env-steps/s; engine step {prof['launches']:.0f} kernel launches, "
          f"{prof['said']} (the reset branch "
          f"{reset['launches']:.0f} launches, {reset['said']} of it); K1, K2 "
          f"and the PGS kernel launched 0 times ({time.perf_counter() - t1:.1f} s)")
    t2 = time.perf_counter()
    short = [(t, {"max_episode_steps": 1}) for t in ids
             if t not in ("MiniGrid-Empty-8x8-v0", boss)]
    phase_exact_checks(device, short, n=N_MINIGRID_SHORT, warmup=0, steps=2, state=True)
    print(f"minigrid: {time.perf_counter() - t0:.1f} s (MiniGrid-Empty-8x8-v0 {t1 - t0:.1f}, "
          f"{boss} {t2 - t1:.1f}, the other {len(short)} ids {time.perf_counter() - t2:.1f})")
    return {"empty": empty, "boss": dict(prof, steps_per_s=steps_per_s,
                                         reset_launches=reset["launches"],
                                         reset_device_ms=reset["device_ms"])}


# board/pgx: TicTacToe-v1 at N_BOARD envs (bench.py:206's row, its
# 256-step rollout) and Go19x19-v1, the family's heaviest step (two
# fixpoint loops over [N, 19, 19] per step), at N_BOARD envs, profiled,
# timed and checked card vs CPU GO_DEPTH legal moves in (chains, captures,
# ko: the loops' passes grow with them); TicTacToe-v1's
# per-player rows at N_BOARD_ROWS; every other board id exact at
# N_BOARD_SHORT envs in episodes of BOARD_EPISODE steps, checked across
# their end and the reset after it.
N_BOARD = 8192
N_BOARD_ROWS = 256
N_BOARD_SHORT = 64
GO_DEPTH = 40
BOARD_EPISODE = 5


def section_board(device: str, card: str) -> dict:
    """TicTacToe-v1 at ``N_BOARD`` envs through every entry point (card vs
    CPU equal in every field of the state and the timestep, by legal
    moves, resets among the checked steps; profiles of the step and of its
    reset branch; the 256-step rollout) and with 2 players' action rows,
    Go19x19-v1 at ``N_BOARD`` (``GO_DEPTH`` legal moves in: a profile of
    the step and the fixpoint loops' passes on its boards, a 16-step
    rollout, card vs CPU equal in every field; a profile of the reset
    branch), and every other board id exact at ``N_BOARD_SHORT``; none may
    launch K1, K2 or the PGS kernel.  Returns the main paths' numbers."""
    from envpool_tpu_torch.core.registry import registry
    from envpool_tpu_torch.envs.board import go as go_env
    from envpool_tpu_torch.envs.board.common import min_labels

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items() if path.endswith(".board")]
    ttt, go = "TicTacToe-v1", "Go19x19-v1"
    # Episodes of 5 steps in the adapters' run: a game of random actions
    # rarely lasts longer.
    tic = section_render(device, card, ttt, N_BOARD, BOARD_EPISODE, 256, N_BOARD, 0.0,
                         exact_state=True, legal=True)
    kernels = _kernel_launches()
    for k in kernels:
        k.launches = 0
    rows = phase_state_card_vs_cpu(device, ttt, N_BOARD_ROWS, 8, 3, legal=True,
                                   max_num_players=2)
    _check(rows["resets"] > 0, f"{ttt} with 2 players: no reset among the checked steps")
    t1 = time.perf_counter()
    prof = phase_profile(device, go, N_BOARD, PROFILE_STEPS, warmup=GO_DEPTH, legal=True)
    board = prof.pop("ps").env_state["board"]
    passes = []
    for loop in (go_env.chain_labels, go_env.area_score):
        min_labels.passes = 0
        loop(board)
        passes.append(min_labels.passes)
    reset = phase_profile_reset(device, go, N_BOARD)
    steps_per_s, _ = phase_throughput(device, go, N_BOARD, 16, depth=GO_DEPTH, legal=True)
    phase_state_card_vs_cpu(device, go, N_BOARD, GO_DEPTH, 2, legal=True)
    _check(all(k.launches == 0 for k in kernels),
           f"{ttt} with 2 players or {go} launched K1, K2 or the PGS kernel")
    print(f"{go} at {N_BOARD} envs on {card}, {GO_DEPTH} legal moves in: functional rollout "
          f"of 16 steps {steps_per_s:,.0f} env-steps/s; engine step {prof['launches']:.0f} "
          f"kernel launches, {prof['said']}, "
          f"the fixpoint loops' passes on its boards ({float((board != 0).sum()) / N_BOARD:.1f} "
          f"stones a board): chains {passes[0]}, empty regions {passes[1]}; the reset branch "
          f"{reset['launches']:.0f} launches, {reset['said']}; K1, K2 and "
          f"the PGS kernel launched 0 times ({time.perf_counter() - t1:.1f} s)")
    t2 = time.perf_counter()
    short = [(t, {"max_episode_steps": BOARD_EPISODE}) for t in ids if t not in (ttt, go)]
    phase_exact_checks(device, short, n=N_BOARD_SHORT, warmup=BOARD_EPISODE - 1, steps=3,
                       state=True, legal=True)
    print(f"board: {time.perf_counter() - t0:.1f} s ({ttt} {t1 - t0:.1f}, {go} {t2 - t1:.1f}, "
          f"the other {len(short)} ids {time.perf_counter() - t2:.1f})")
    return {"tictactoe": tic, "go": dict(prof, steps_per_s=steps_per_s,
                                         reset_launches=reset["launches"],
                                         reset_device_ms=reset["device_ms"])}


# highway: Highway-v0 at N_HIGHWAY envs (bench.py:207's row) and
# Intersection-v0 (the lane-network scenarios: routes, circular lanes,
# regulated yielding) at N_HIGHWAY, each through every entry point (the
# gymnasium pool's episodes cut at HIGHWAY_EPISODE steps), card vs CPU by
# the rule at N_HIGHWAY_VS envs after HIGHWAY_WARMUP steps in episodes of
# HIGHWAY_WARMUP + 1 (the checked steps end them, reset, step again),
# profiled (the reset branch alone too) and timed over HIGHWAY_ROLLOUT
# steps; every other highway id by the rule at N_RENDER_SHORT envs, 3
# checked steps after HIGHWAY_SHORT_WARMUP in episodes of one more.
N_HIGHWAY = 2048
N_HIGHWAY_VS = 256
HIGHWAY_EPISODE = 5
HIGHWAY_WARMUP = 8
HIGHWAY_ROLLOUT = 16
HIGHWAY_SHORT_WARMUP = 2


def section_highway(device: str, card: str) -> dict:
    """Highway-v0 and Intersection-v0 at ``N_HIGHWAY`` envs through every
    phase (:func:`section_render`, card vs CPU by the rule of
    ``ops/thresholds.py``), and every other highway id by the rule; none
    may launch K1, K2 or the PGS kernel.  Returns the main paths'
    numbers."""
    from envpool_tpu_torch.core.registry import registry

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items()
           if path.endswith(".highway") and t[0].isupper()]  # the ids, not the aliases
    out = {}
    laps = []
    for task in ("Highway-v0", "Intersection-v0"):
        out[task] = section_render(device, card, task, N_HIGHWAY, HIGHWAY_EPISODE,
                                   HIGHWAY_ROLLOUT, N_HIGHWAY_VS, None, warmup=HIGHWAY_WARMUP)
        laps.append(time.perf_counter())
    short = [t for t in ids if t not in out]
    phase_rule_checks(device, "highway", short, warmup=HIGHWAY_SHORT_WARMUP)
    print(f"highway: {time.perf_counter() - t0:.1f} s (Highway-v0 {laps[0] - t0:.1f}, "
          f"Intersection-v0 {laps[1] - laps[0]:.1f}, the other {len(short)} ids "
          f"{time.perf_counter() - laps[1]:.1f})")
    return out


# robotics and MetaWorld: FetchPickAndPlace-v4 (the object, the grasp, the
# goal in the air, the rejection-sampled reset), HandReach-v3 (the
# fingertips' forward kinematics on the committed Shadow Hand model) and
# MetaWorld/PickPlace-v3 (the full caging reward law) at N_GOAL envs, each
# through every entry point (the gymnasium pool's episodes cut at
# GOAL_EPISODE steps), card vs CPU by the rule at N_GOAL_VS envs after a
# warm-up in episodes of one step more, profiled (the reset branch alone
# too) and timed over GOAL_ROLLOUT steps; every other id of both families
# by the rule at N_RENDER_SHORT envs, 3 checked steps after
# GOAL_SHORT_WARMUP in episodes of one more.  Uniform random actions never
# grasp, so the two pick-and-place paths are steered at the object
# (:func:`_steer`): Fetch's warm-up of 8 steps ends with the object grasped
# and lifted, MetaWorld's of 16 (1 cm a step) where the caging reward and
# the reward are above 0 in about half the envs.
N_GOAL = 8192
N_GOAL_VS = 256
GOAL_EPISODE = 5
GOAL_ROLLOUT = 64
GOAL_SHORT_WARMUP = 2


def _steer(tip: str, scale: float, near: float, close: float, lift: float, noise: float):
    """A policy that moves the gripper (state field ``tip``) at the object
    (``obj_pos``), at full speed beyond ``scale``, closes it (gripper
    action ``close``) within ``near`` of the object and lifts there
    (``lift``), with Gaussian noise of scale ``noise``: the grasp that
    uniform random actions never reach."""
    import torch

    def act(st, gen):
        d = (st["obj_pos"] - st[tip]).cpu()
        at = d.norm(dim=1) < near
        a = torch.zeros(len(d), 4)
        a[:, :3] = (d / scale).clamp(-1, 1)
        a[:, 2] += torch.where(at, lift, 0.0)
        a[:, 3] = torch.where(at, close, -close)
        return (a + noise * torch.randn(a.shape, generator=gen)).clamp(-1, 1)

    return act


def _goal_mains() -> dict:
    """Each goal-family main path's card-vs-CPU warm-up, policy and the
    mechanism its checked steps must reach."""
    return {
        "FetchPickAndPlace-v4": dict(
            warmup=8, policy=_steer("grip_pos", 0.0315, 0.04, -1.0, 0.8, 0.2),
            reached=("holding the object in the air",
                     lambda ts, st: st["grasped"] & (st["obj_pos"][:, 2] > 0.435))),
        "HandReach-v3": dict(warmup=8),
        "MetaWorld/PickPlace-v3": dict(
            warmup=16, policy=_steer("tcp", 0.01, 0.05, 1.0, 0.6, 0.3),
            reached=("with a caging reward and a reward above 0",
                     lambda ts, st: (ts["info:grasp_reward"] > 0) & (ts["reward"] > 0))),
    }


def _goal_family(device: str, card: str, family: str, mains: tuple) -> dict:
    """The main paths ``mains`` of the family whose registry path ends in
    ``family`` through every phase (:func:`section_render`), and every
    other id of it by the rule; none may launch K1, K2 or the PGS kernel.
    Returns the main paths' numbers."""
    from envpool_tpu_torch.core.registry import registry

    t0 = time.perf_counter()
    ids = [t for t, (path, _, _) in registry.specs.items() if path.endswith(family)]
    out, laps = {}, [t0]
    for task in mains:
        out[task] = section_render(device, card, task, N_GOAL, GOAL_EPISODE, GOAL_ROLLOUT,
                                   N_GOAL_VS, None, **_goal_mains()[task])
        laps.append(time.perf_counter())
    short = [t for t in ids if t not in out]
    phase_rule_checks(device, family.lstrip("."), short, warmup=GOAL_SHORT_WARMUP)
    print(f"{family.lstrip('.')}: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{t} {b - a:.1f}" for t, a, b in zip(mains, laps, laps[1:]))
          + f", the other {len(short)} ids {time.perf_counter() - laps[-1]:.1f})")
    return out


def section_robotics(device: str, card: str) -> dict:
    """FetchPickAndPlace-v4 and HandReach-v3 at ``N_GOAL`` envs through
    every phase, and the other 155 robotics ids by the rule."""
    return _goal_family(device, card, ".robotics", ("FetchPickAndPlace-v4", "HandReach-v3"))


def section_metaworld(device: str, card: str) -> dict:
    """MetaWorld/PickPlace-v3 at ``N_GOAL`` envs through every phase, and
    the other 49 MetaWorld ids by the rule."""
    return _goal_family(device, card, ".metaworld", ("MetaWorld/PickPlace-v3",))


def _pole_outline(states, tol: float = 1e-3):
    """``[N, 400, 600]``: the pixels of CartPole frames that lie within
    ``tol`` pixel of the pole's outline, in float64 (where a float32 cos or
    sin an ulp apart may paint either side)."""
    import torch

    x, theta = states[:, 0, None, None].double(), states[:, 2, None, None].double()
    cart_x = 300 + x * (600 / (2 * 2.4 * 2))
    rows = torch.arange(400, dtype=torch.float64)[:, None]
    cols = torch.arange(600, dtype=torch.float64)[None, :]
    dx, dy = cols - cart_x, 300.0 - 15 - rows
    along = dx * torch.sin(theta) + dy * torch.cos(theta)
    across = dx * torch.cos(theta) - dy * torch.sin(theta)
    return (along.abs() <= tol) | ((along - 100).abs() <= tol) | ((across.abs() - 5).abs() <= tol)


def phase_surface_checks(device: str) -> None:
    """The engine's remaining surface on the card, a few seconds each:
    ``render()`` of CartPole-v1 and PongLite-v5 equal to the CPU's render
    of the same states (CartPole's except within 1e-3 pixel of the pole's
    outline); a ``save_state`` / step / ``load_state`` / step round trip
    bit for bit (CartPole-v1, CheetahRun-v1 from pixels); ``record_dir``
    files on the card; and FrameStack and NormalizeObs over CartPole-v1,
    card against CPU from the same states."""
    import glob
    import os
    import tempfile

    import torch

    import envpool_tpu_torch
    from envpool_tpu_torch import interop, wrappers
    from envpool_tpu_torch.core.engine import Engine, PoolState, _tree_map
    from envpool_tpu_torch.envs.classic_control import CartPoleEnv

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    for task, n, steps in (("CartPole-v1", 64, 5), ("PongLite-v5", 8, 20)):
        card = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=SEED,
                                      device=device)
        cpu = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=SEED,
                                     device="cpu")
        card.reset()
        sample = _sampler(_spec(card), n, "cpu")
        for _ in range(steps):
            card.step(sample(gen).numpy())
        cpu._state = interop.pool_state_from_numpy(interop.pool_state_to_numpy(
            card.pool_state), "cpu")
        got, want = card.render(), cpu.render()
        differ = (got != want).any(-1)
        if task.startswith("CartPole"):
            outline = _pole_outline(cpu.pool_state.env_state).numpy()
            _check(not (differ & ~outline).any(), f"{task}: card and CPU frames differ away "
                   "from the pole's outline")
        else:
            _check(not differ.any(), f"{task}: card and CPU frames differ")
        print(f"{task} render() on the card: {got.shape} {got.dtype}, equal to the CPU's "
              f"render of the same states but {int(differ.sum())} pixels")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    for task, n, kwargs in (("CartPole-v1", 256, {}),
                            ("CheetahRun-v1", 64, {"from_pixels": True})):
        pool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=SEED,
                                      device=device, numpy_output=False, **kwargs)
        pool.reset()
        sample = _sampler(_spec(pool), n, device)
        acts = [sample(torch.Generator(device=device).manual_seed(SEED + i)) for i in range(3)]
        pool.step(acts[0])
        path = os.path.join(tmp, f"{task}.npz")
        pool.save_state(path)
        first = [pool.step(a) for a in acts[1:]]
        pool.load_state(path)
        again = [pool.step(a) for a in acts[1:]]
        same = all(torch.equal(x, y) for f, g in zip(first, again) for x, y in zip(f[:4], g[:4]))
        _check(same, f"{task}{_kw(kwargs)}: the steps after load_state differ")
        print(f"{task}{_kw(kwargs)} at {n} envs: save_state, 2 steps, load_state, the same 2 "
              f"steps: equal bit for bit")
    rec = os.path.join(tmp, "record")
    pool = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=256, seed=SEED,
                                  device=device, max_episode_steps=10, record_dir=rec)
    pool.reset()
    dones = 0
    for _ in range(25):
        *_, term, trunc, _ = pool.step(np.random.default_rng(dones).integers(0, 2, 256)
                                       .astype(np.int32))
        dones += int((term | trunc).sum())
    files = glob.glob(os.path.join(rec, "env_*_*.npz"))
    _check(len(files) == dones > 0, f"record_dir: {len(files)} files for {dones} episodes")
    with np.load(sorted(files)[0]) as z:
        _check(z["action"].ndim == 1 and 0 < len(z["action"]) <= 10, "a recorded episode")
    print(f"record_dir on the card: {len(files)} episode files for {dones} finished episodes")
    for name, wrap in (("FrameStack", lambda e: wrappers.FrameStack(e, 4)),
                       ("NormalizeObs", wrappers.NormalizeObs)):
        n = 1024
        card = Engine(wrap(CartPoleEnv.from_config(num_envs=n, seed=SEED, device=device,
                                                   max_episode_steps=20)))
        cpu = Engine(wrap(CartPoleEnv.from_config(num_envs=n, seed=SEED, device="cpu",
                                                  max_episode_steps=20)))
        ps, _ = card.reset(card.init(), torch.ones(n, dtype=torch.bool, device=device))
        worst, flips = 0.0, 0
        for t in range(15):
            act = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
            ps_cpu = PoolState(*(_tree_map(lambda x: x.cpu(), f) for f in (
                ps.env_state, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)))
            ps, got = card.step(ps, {"action": act.to(device)})
            if t < 12:
                continue
            cps, want = cpu.step(ps_cpu, {"action": act})
            # Envs whose new CartPole state lies within the tolerance of a
            # termination threshold may end on one device only.
            keep = ~(_cartpole_margin({"obs": cps.env_state["inner"]}) < CARTPOLE_TOL)
            flips += int((~keep).sum())
            limit = {k: CARTPOLE_TOL for k in want}
            if name == "NormalizeObs":
                # The normalisation divides the state's float32 rounding
                # by the running standard deviation.
                stats = cps.env_state["stats"]
                var = stats["m2"] / torch.clamp_min(stats["count"] - 1, 1)[:, None]
                limit["obs"] = (4 * CARTPOLE_TOL * (1 + cps.env_state["inner"].abs())
                                / torch.sqrt(var + 1e-8))
            for k, w in want.items():
                g = got[k].cpu()
                if w.is_floating_point():
                    err = ((g - w).abs() / (1 + w.abs())).reshape(n, -1)[keep]
                    ratio = float((err / torch.as_tensor(limit[k]).reshape(n, -1)[keep]
                                   if k == "obs" and name == "NormalizeObs"
                                   else err / limit[k]).max())
                    worst = max(worst, ratio)
                    _check(ratio <= 1, f"{name}: {k} past its tolerance ({ratio:.3g} of it) "
                           f"at step {t}")
                else:
                    _check(torch.equal(g[keep], w[keep]), f"{name}: {k} differs at step {t}")
        print(f"{name} over CartPole-v1, {n} envs x 3 steps card vs CPU from the same states: "
              f"largest error {worst:.3g} of its tolerance ({CARTPOLE_TOL:g} · (1 + |cpu|)"
              + ("; the normalised obs 4x that over the running std" if name == "NormalizeObs"
                 else "") + f"); {flips} envs at a termination threshold left out")
    print(f"surface checks passed ({time.perf_counter() - t0:.1f} s)")


def phase_exact_checks(device: str, checks: list[tuple[str, dict]], n: int = N_EXACT,
                       warmup: int = 12, steps: int = 8, state: bool = False,
                       legal: bool = False) -> None:
    """A short card-vs-CPU check of each toy_text id, of Dummy-v0, of
    procgen's grid ids, of the minigrid ids and of the board ids (with its
    make arguments): ``n`` envs, ``steps`` checked steps after ``warmup``
    warm-up steps, every field of the timestep equal (their state is
    integer and their float fields exact), and with ``state`` every field
    of the env state too (:func:`phase_state_card_vs_cpu`, by legal moves
    with ``legal``), with resets among the checked steps; none may launch
    K1, K2 or the PGS kernel."""
    kernels = _kernel_launches()
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    for task, kwargs in checks:
        if state:
            v = phase_state_card_vs_cpu(device, task, n, warmup, steps, legal=legal, **kwargs)
        else:
            print(f"  {task} {kwargs}:")
            v = phase_float_card_vs_cpu(device, task, n, warmup=warmup, steps=steps,
                                        tol=0.0, **kwargs)
            _check(v["worst"] == 0.0, f"{task}: card and CPU differ")
        _check(v["resets"] > 0, f"{task}: no reset among the checked steps")
    _check(all(k.launches == 0 for k in kernels), "an exact-checked id launched K1, K2 or PGS")
    print(f"exact card-vs-CPU checks of {len(checks)} pools passed; K1, K2 and the PGS "
          f"kernel launched 0 times ({time.perf_counter() - t0:.1f} s)")


def phase_short_checks(device: str, family: str, tasks: list[str], later: CpuSide,
                       share_warmup: bool = False, n: int | None = None,
                       **make_kwargs) -> None:
    """A short card-vs-CPU check of each id of a physics family, as deep as
    :func:`_short_depth` says, at ``n`` envs (by default ``N_SHORT``,
    ``N_SHORT_FREE`` for the Gym-MuJoCo ids with a free base), with
    ``share_warmup`` one warm-up for ids that step alike
    (:func:`phase_float_card_vs_cpu`), ``make_kwargs`` to every pool;
    none may launch K1 or K2, and only the constraint solver's
    (``contact_solver="mujoco"``) the PGS kernel (:func:`family_checks`).
    The CPU's side of every id's check and the family's checks after them
    run in ``later``'s worker process, in the same order, while the card
    goes on with the next id; the kernels' launches are read here when the
    family's card work is done."""
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    t0 = time.perf_counter()
    machine_frame.launches = 0
    fused_pool_resize.launches = 0
    pgs_solve.launches = 0
    warm = {} if share_warmup else None
    width = n
    for task in tasks:
        later.poll()  # a failed check fails the run at once
        n = width or (N_SHORT_FREE if task.split("-")[0] in FREE_BASE else N_SHORT)
        t_task = time.perf_counter()
        steps, warmup = _short_depth(task)
        phase_float_card_vs_cpu(device, task, n, warmup=warmup, steps=steps,
                                tol=PHYSICS_TOL, spread=_spread(task), warm=warm,
                                later=later, family=family, **make_kwargs)
        say(f"  ({task}: {time.perf_counter() - t_task:.1f} s of the card's side)")
    later.submit(family_checks, family, make_kwargs, (
        fused_pool_resize.launches, machine_frame.launches, pgs_solve.launches),
        time.perf_counter() - t0, t0)


def family_checks(family: str, make_kwargs: dict, launches: tuple, card_s: float,
                  t0: float) -> None:
    """The checks after a family's short checks: the card's float32 steps
    as close to float64 as the CPU's over all its ids, and the kernels'
    ``launches`` (K1, K2, PGS) during its card work (which took ``card_s``
    where the CPU's side ran apart)."""
    import torch

    done = _FAMILY_RESULTS.pop(family)
    for what in ("", "_obs"):
        check_f64_parity(f"the {len(done)} short {family} checks, {what[1:] or 'state'}",
                         *(torch.cat([v[k + what] for v in done]) for k in ("card", "cpu")),
                         PHYSICS_TOL)
    _check(launches[0] == launches[1] == 0, f"a {family} id launched K1 or K2")
    solver = make_kwargs.get("contact_solver") == "mujoco"
    _check((launches[2] > 0) == solver,
           f"the {family} ids launched the PGS kernel {launches[2]} times")
    took = time.perf_counter() - t0
    say(f"short card-vs-CPU checks of {len(done)} {family} ids{_kw(make_kwargs)} passed; K1 "
        f"and K2 launched 0 times, the PGS kernel {launches[2]} ({card_s:.1f} s of the card's "
        f"side; done {took:.1f} s after it began)")


def _short_depth(task: str) -> tuple[int, int]:
    """``(checked steps, warm-up steps)`` of a short check: ``SHORT_STEPS``
    of its family for the earlier slices' ids (the Gym-MuJoCo ids after
    ``SHORT_WARMUP_GYM`` warm-up steps), 3 for the newest (the Dog ids),
    after 30 otherwise."""
    from envpool_tpu_torch.core.registry import registry

    path, cls, _ = registry.specs[task]
    if path.endswith(".mujoco_gym"):
        return SHORT_STEPS["gym"], SHORT_WARMUP_GYM
    return (3 if cls == "DogEnv" else SHORT_STEPS["dmc"]), 30


def _is_dmc(task: str) -> bool:
    from envpool_tpu_torch.core.registry import registry

    return registry.specs[task][0].endswith(".mujoco_dmc")


def _spread(task: str) -> bool:
    if _is_dmc(task):
        return task in DMC_SPREAD
    return task.split("-")[0] in SPREAD


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import envpool_tpu_torch  # (fails outside the repository)
    from envpool_tpu_torch.core.registry import registry
    from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
    from envpool_tpu_torch.ops.cuda_machine import machine_frame
    from envpool_tpu_torch.ops.cuda_pgs import pgs_solve

    t_start = time.perf_counter()
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    from envpool_tpu_torch.tools.k2_probe import smi

    card = smi("name,power.limit")
    print(f"device: {kind}")
    print(card)
    print(host_cpu())
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.allow_tf32 = False
    dmc_short = [t for t, (path, _, _) in registry.specs.items()
                 if path.endswith(".mujoco_dmc") and not t.startswith("Dog")
                 and t not in ("CheetahRun-v1", "QuadrupedRun-v1")]
    dog_short = [t for t in registry.specs if t.startswith("Dog") and t != "DogRun-v1"]
    # Every toy_text id but the main path's, and Dummy-v0 at one and two
    # players; episodes cut at 8 steps, so that the checked steps (the 13th
    # to the 20th) cross an auto-reset of every env.
    exact = [(t, {"max_episode_steps": 8}) for t, (path, _, _) in registry.specs.items()
             if path.endswith(".toy_text") and t != "FrozenLake8x8-v1"]
    exact += [("Dummy-v0", {"max_episode_steps": 8, "max_num_players": p}) for p in (1, 2)]

    # Build the three kernels at once (one nvcc each), and meanwhile solve
    # the WFC map banks the minigrid section's pools read.
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(k.build) for k in (fused_pool_resize, machine_frame, pgs_solve)]
        banks = pool.submit(build_wfc_banks)
        k1_build, k2_build, pgs_build = (b.result() for b in builds)
        banks_s = banks.result()
    print(f"K1 build: {k1_build:.1f} s; K2 build: {k2_build:.1f} s; PGS build: "
          f"{pgs_build:.1f} s; the six WFC banks: {banks_s:.1f} s (in parallel)")

    stats, k1_launches = section_pong(device, card)
    print(f"[{time.perf_counter() - t_start:.1f} s] PongLite-v5 and K1 done")
    k2_stats, k2_launches = section_machine(device, card)
    print(f"[{time.perf_counter() - t_start:.1f} s] Machine2600-v0 and K2 done")

    # -- CartPole-v1, FrozenLake8x8-v1 and the physics: no Pallas kernel on
    # their path -----------------------------------------------------------
    for task, n, episode, tol, rollout_steps, vs_n in (
        ("CartPole-v1", N_CARTPOLE, 15, CARTPOLE_TOL, 512, None),
        ("FrozenLake8x8-v1", N_FROZEN, 15, 0.0, 512, None),
        ("HalfCheetah-v4", N_CHEETAH, 20, PHYSICS_TOL, 64, N_MAIN_VS),
        ("Ant-v4", N_ANT, 10, PHYSICS_TOL, 64, N_MAIN_VS),
        ("Humanoid-v4", N_HUMANOID, 10, PHYSICS_TOL, 16, N_MAIN_VS),
        ("CheetahRun-v1", N_DMC, 10, PHYSICS_TOL, 128, N_MAIN_VS),
        ("QuadrupedRun-v1", N_DMC, 10, PHYSICS_TOL, 16, N_MAIN_VS),
    ):
        phase_physics(device, card, task, n, episode, tol, rollout_steps, vs_n=vs_n)
    phase_physics(device, card, "DogRun-v1", N_DMC, 4, PHYSICS_TOL, 4, vs_n=N_DOG_VS)
    print(f"[{time.perf_counter() - t_start:.1f} s] main paths done")
    # -- the constraint solver (the PGS kernel), from_pixels, the grid and
    # board families; every other physics id a short card-vs-CPU check: the
    # CPU's side of the physics short checks runs in a worker process while
    # the card goes on with the next id -------------------------------------
    with CpuSide() as later:
        pgs_stats, pgs_launches = section_solver(device, card, later)
        print(f"[{time.perf_counter() - t_start:.1f} s] the solver and the PGS kernel done")
        section_pixels(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] from_pixels done")
        section_procgen(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] procgen done")
        section_vizdoom(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] vizdoom done")
        section_minigrid(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] minigrid done")
        section_board(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] board done")
        section_highway(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] highway done")
        section_robotics(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] robotics done")
        section_metaworld(device, card)
        print(f"[{time.perf_counter() - t_start:.1f} s] metaworld done")
        phase_exact_checks(device, exact)
        phase_surface_checks(device)
        t_short = time.perf_counter()
        phase_short_checks(device, "Gym-MuJoCo", [
            t for t, (path, _, _) in registry.specs.items()
            if path.endswith(".mujoco_gym") and not t.startswith("HalfCheetah")
            and t not in ("Ant-v4", "Humanoid-v4")], later)
        phase_short_checks(device, "dm_control", dmc_short, later, share_warmup=True)
        phase_short_checks(device, "dog", dog_short, later, share_warmup=True, n=N_DOG_SHORT)
        waited = later.drain()
    print(f"[{time.perf_counter() - t_start:.1f} s] short checks done "
          f"({time.perf_counter() - t_short:.1f} s; the CPU's side in a worker process, "
          f"{waited:.1f} s of it after the card's side had ended)")

    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {
            "name": "K1",
            "route": "cuda",
            "source": "envpool_tpu_torch/csrc/pool_resize.cu",
            "replaces": "envpool_tpu/ops/pallas_image.py:33",
            "launches": k1_launches,
            **stats,
        },
        {
            "name": "K2",
            "route": "cuda",
            "source": "envpool_tpu_torch/csrc/machine_frame.cu",
            "replaces": "envpool_tpu/envs/atari/machine_pallas.py:33",
            "launches": k2_launches,
            **k2_stats,
        },
        {
            "name": "PGS",
            "route": "cuda",
            "source": "envpool_tpu_torch/csrc/pgs_solve.cu",
            "replaces": "envpool_tpu/physics/solver.py:187",
            "launches": pgs_launches,
            **pgs_stats,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
