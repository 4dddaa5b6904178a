"""Repeat a card-vs-CPU check many times, and step the card twice from one
state, to tell a card that is not deterministic from a check that is wrong.

Run from the repository root, beside ``chip_smoke.py`` (whose phases it
repeats), on one CUDA card::

    python3 repeat_card_vs_cpu.py [--runs 50]
        [--tasks CartPole-v1 ...] [--n 16384] [--spread] [--after-kernels 20]
        [--no-determinism] [--with-adapters]

For each task it runs ``chip_smoke.phase_float_card_vs_cpu`` ``--runs``
times in one process (30 warm-up steps, 3 checked steps, as
``chip_smoke.py`` does; the physics under the strict rule unless
``--spread``; each after ``phase_float_adapters`` with
``--with-adapters``) and prints each run's largest error, or its failure,
and its time.  Then it takes one pool state after 30 warm-up steps and steps the
card from it twice with one action, and runs the whole seeded sequence
(reset, 33 steps) twice, and holds the two results of each to be equal bit
for bit.  With
``--after-kernels K``, it then builds K1 and K2, runs everything
``chip_smoke.py`` runs before its CartPole-v1 phases (K1, PongLite-v5, K2
and Machine2600-v0: ``section_pong``, ``section_machine``) and repeats the
check ``K`` more times.  Exits non-zero when a
run failed, the card was not deterministic or no CUDA device is present.
"""

from __future__ import annotations

import argparse
import sys
import time


def _run_sequence(task: str, n: int, steps: int, seed: int, device: str = "cuda"):
    """The card's pool state after a reset and ``steps`` seeded random
    steps, and the last timestep."""
    import torch

    import chip_smoke

    pool = chip_smoke._pool(device, task, n)
    eng = pool.engine
    gen = torch.Generator().manual_seed(seed)
    sample = chip_smoke._sampler(chip_smoke._spec(pool), n, "cpu")
    ps, ts = eng.reset(pool.pool_state, torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(steps):
        ps, ts = eng.step(ps, {"action": sample(gen).to(device)})
    torch.cuda.synchronize()
    return ps, ts, sample, gen


def _flat(ps, ts) -> dict:
    import dataclasses

    out = {f"ts:{k}": v for k, v in ts.items()}
    for f in dataclasses.fields(ps):
        v = getattr(ps, f.name)
        if isinstance(v, dict):
            out.update({f"state:{k}": x for k, x in v.items()})
        else:
            out[f"pool:{f.name}"] = v
    return out


def _differ(a: dict, b: dict) -> list[str]:
    import torch

    return [f"{k} ({int((a[k] != b[k]).reshape(len(a[k]), -1).any(1).sum())} rows)"
            for k in a if not torch.equal(a[k], b[k])]


def determinism(task: str, n: int, device: str = "cuda") -> list[str]:
    """Bit-for-bit checks of the card: one state stepped twice with one
    action, and the whole seeded sequence run twice.  Returns what
    differed."""
    import chip_smoke

    bad = []
    ps, _, sample, gen = _run_sequence(task, n, 30, chip_smoke.SEED, device)
    act = {"action": sample(gen).to(device)}
    eng = chip_smoke._pool(device, task, n).engine
    a = _flat(*eng.step(ps, act))
    b = _flat(*eng.step(ps, act))
    bad += [f"one state stepped twice: {d}" for d in _differ(a, b)]
    runs = [_flat(*_run_sequence(task, n, 33, chip_smoke.SEED, device)[:2])
            for _ in range(2)]
    bad += [f"the seeded sequence run twice: {d}" for d in _differ(*runs)]
    print(f"{task} at {n} envs: one state stepped twice with one action, and the "
          f"seeded sequence (reset + 33 steps) run twice: "
          + ("bit-identical" if not bad else "DIFFERENT: " + "; ".join(bad)))
    return bad


def repeat(task: str, n: int, runs: int, label: str, spread: bool = False,
           adapters: bool = False) -> list[float | str]:
    """``runs`` calls of ``chip_smoke.phase_float_card_vs_cpu``, each after
    ``chip_smoke.phase_float_adapters`` with ``adapters`` (as
    ``chip_smoke.py`` runs them): each run's largest error, or its failure
    message."""
    import chip_smoke

    tol = chip_smoke.CARTPOLE_TOL if task == "CartPole-v1" else chip_smoke.PHYSICS_TOL
    results: list[float | str] = []
    for i in range(runs):
        t0 = time.perf_counter()
        try:
            if adapters:
                chip_smoke.phase_float_adapters("cuda", task, n, 15)
            v = chip_smoke.phase_float_card_vs_cpu("cuda", task, n, warmup=30,
                                                   steps=3, tol=tol, spread=spread)
            results.append(v["worst"])
        except RuntimeError as e:  # recorded and counted, never passed over
            results.append(str(e))
        print(f"{label} run {i + 1}/{runs} ({time.perf_counter() - t0:.1f} s): "
              f"{results[-1]}", flush=True)
    worst = [r for r in results if isinstance(r, float)]
    failed = [r for r in results if isinstance(r, str)]
    print(f"{label}: {runs} runs of {task} card vs CPU at {n} envs: {len(failed)} "
          f"failed; largest error of the passing runs "
          f"{max(worst) if worst else float('nan'):.4g}, smallest "
          f"{min(worst) if worst else float('nan'):.4g}")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("repeat_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from envpool_tpu_torch.tools.k2_probe import smi

    p = argparse.ArgumentParser()
    p.add_argument("--tasks", nargs="+", default=["CartPole-v1"])
    p.add_argument("--n", type=int, default=chip_smoke.N_CARTPOLE)
    p.add_argument("--runs", type=int, default=50)
    p.add_argument("--spread", action="store_true")
    p.add_argument("--after-kernels", type=int, default=0)
    p.add_argument("--no-determinism", action="store_true")
    p.add_argument("--with-adapters", action="store_true")
    args = p.parse_args()
    print(smi("name,power.limit"))
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    results, bad = [], []
    for task in args.tasks:
        results += repeat(task, args.n, args.runs, f"{task} alone", args.spread,
                          args.with_adapters)
        if not args.no_determinism:
            bad += determinism(task, args.n)
    if args.after_kernels:
        from envpool_tpu_torch.ops.cuda_image import fused_pool_resize
        from envpool_tpu_torch.ops.cuda_machine import machine_frame

        for k in (fused_pool_resize, machine_frame):
            k.build()
        card = smi("name,power.limit")
        chip_smoke.section_pong("cuda", card)
        chip_smoke.section_machine("cuda", card)
        task = args.tasks[0]
        results += repeat(task, args.n, args.after_kernels,
                          "after the K1, PongLite-v5, K2 and Machine2600-v0 phases",
                          args.spread, args.with_adapters)
        bad += determinism(task, args.n)
    failed = sum(isinstance(r, str) for r in results)
    print(f"{len(results)} runs, {failed} failed; card deterministic: {not bad}")
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
