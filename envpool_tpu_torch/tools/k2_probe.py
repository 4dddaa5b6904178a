"""What K2's design rests on, measured on one CUDA card.

Run from the repository root: ``python -m envpool_tpu_torch.tools.k2_probe``.
It prints the frame kernel's ``-Xptxas -v`` report and code size (and
writes its SASS to ``envpool_tpu_torch/_build/k2_probe/``), builds K2
with every geometry (machines per warp, ``GEOMETRIES``) and holds each
against the plain frame on the pong, F8, F6 and a random cart, measures
the latency of one dependent shared-memory load, and times every
geometry on the pong cart at ``--n`` machines with lanes that differ and
lanes in lockstep (every machine gets the same joystick inputs), in
turns (A B ... B A), then at twice ``--n`` and at ``--wide`` machines.
``--against SOURCE`` does all of that for a second ``machine_frame.cu``
too, in the same turns, so that two versions are compared within one
run. ``--phases`` instead prints where one frame's SM clocks go, from a
copy of the kernel that reads ``clock64`` around each phase of every
instruction. It exits non-zero when no CUDA device is present."""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_PKG = pathlib.Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
_SOURCE = _PKG / "csrc" / "machine_frame.cu"
_OUT = _PKG / "_build" / "k2_probe"
SEED = 20260


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_report(src: pathlib.Path = _SOURCE, sass_dir: pathlib.Path | None = None,
                 tag: str = "machine_frame") -> str:
    """``nvcc -Xptxas -v`` lines of every kernel in ``src`` (the default
    build), and each kernel's code size from its SASS; with ``sass_dir``,
    the SASS (``cuobjdump -sass``) is written there as ``<tag>.sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    bin_dir = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin"
    out = _OUT / f"{tag}.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [str(bin_dir / "nvcc"), "-O3", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-cubin", "-o", str(out), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(out)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    if sass_dir is not None:
        (sass_dir / f"{tag}.sass").write_text(sass)
    lines = [line for line in res.stderr.splitlines()
             if "registers" in line or "stack frame" in line or "Compiling entry" in line]
    for fn in sass.split("Function : ")[1:]:
        n = sum(1 for line in fn.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line))
        lines.append(f"code size {fn.split()[0]}: {n} SASS instructions = {16 * n:,} B")
    return "\n".join(lines)


def carts():
    sys.path.insert(0, str(_REPO / "tests"))
    import machine_carts

    return machine_carts


def machines(rom, n: int, differ: bool = True, device="cuda") -> dict:
    import torch

    from envpool_tpu_torch.envs.atari import cpu6502, tia

    swcha, inpt4 = carts().lane_inputs(n, SEED)
    if not differ:
        swcha, inpt4 = swcha[:1].repeat(n), inpt4[:1].repeat(n)
    g = tia.attach_tia(cpu6502.make_machine(rom, n, device))
    g.update(swcha=torch.as_tensor(swcha, device=device),
             inpt4=torch.as_tensor(inpt4, device=device))
    return g


def time_frames(kernel, g: dict, tables: dict, frames: int) -> tuple[float, dict]:
    """ms per frame over ``frames`` frames from ``g``, and the last state."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(frames):
        g = kernel(g, tables)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames, g


def smem_latency(kernel, iters: int = 1 << 20) -> tuple[float, float]:
    """(SM clocks, ns) of one dependent shared-memory load: one thread's
    pointer chase, clocks from ``clock64``, ns from CUDA events."""
    import torch

    kernel.smem_chase(iters)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = kernel.smem_chase(iters)
    end.record()
    torch.cuda.synchronize()
    return int(out[0]) / iters, start.elapsed_time(end) * 1e6 / iters


# Text edits that make a copy of the kernel time its phases with clock64:
# per machine, [n, 8] int64 through the counts pointer: SM clocks of the
# phases named in PHASES, then the instruction count.
PHASE_EDITS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#define K2_TICK(k) do { const long long "
     "t_ = clock64(); phase[k] += t_ - tick; tick = t_; } while (0)\n"),
    ("  uint32_t instructions;\n", "  uint32_t instructions;\n  long long tick, phase[6];\n"),
    ("    const uint32_t b1 = (w >> 8) & 0xFFu, b2 = (w >> 16) & 0xFFu;\n",
     "    const uint32_t b1 = (w >> 8) & 0xFFu, b2 = (w >> 16) & 0xFFu;\n    K2_TICK(0);\n"),
    ("    auto store = [&](uint32_t value) {", "    K2_TICK(1);\n    auto store = [&](uint32_t value) {"),
    ("    // Bank switching: hotspot on a data/jump access and on the next fetch.\n",
     "    K2_TICK(2);\n    // Bank switching: hotspot on a data/jump access and on the next fetch.\n"),
    ("    }\n#undef K2_OP16", "    }\n    K2_TICK(3);\n#undef K2_OP16"),
    ("      if (instructions > 0) center_missiles();\n",
     "      if (instructions > 0) center_missiles();\n      K2_TICK(4);\n"),
    ("      if (vis >= 0 && vis < kVisible) close_visible(lines + vis * kNReg);\n",
     "      if (vis >= 0 && vis < kVisible) close_visible(lines + vis * kNReg);\n"
     "      K2_TICK(5);\n"),
    ("    scanline = 0;\n    wrapped = 0;\n",
     "    scanline = 0;\n    wrapped = 0;\n    tick = clock64();\n"
     "    for (int k = 0; k < 6; ++k) phase[k] = 0;\n"),
    ("      if (counts != nullptr) counts[first + m] = static_cast<int>(mc.instructions);",
     "      if (counts != nullptr) {\n"
     "        long long* out = reinterpret_cast<long long*>(counts) + (first + m) * 8;\n"
     "        for (int k = 0; k < 6; ++k) out[k] = mc.phase[k];\n"
     "        out[6] = mc.instructions;\n      }"),
]
PHASES = ("loop+fetch", "dispatch+address+operand", "op+TIA", "bank+join",
          "line end", "line close")


def phase_clocks(rom, n: int) -> None:
    """Print where one steady frame's SM clocks go, per machine, from a
    copy of the kernel with PHASE_EDITS, at the default geometry."""
    import torch

    from envpool_tpu_torch.envs.atari import machine_kernel
    from envpool_tpu_torch.ops.cuda_machine import MachineFrame

    text = _SOURCE.read_text()
    for old, new in PHASE_EDITS:
        if old not in text:
            raise RuntimeError(f"phase edit anchor not found: {old!r}")
        text = text.replace(old, new)
    src = _PKG / "_build" / "k2_phases" / "machine_frame.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    k = MachineFrame(src, src.parent, "k2_phases")
    tables = machine_kernel.build_tables(rom, "cuda")
    g = machines(rom, n)
    for _ in range(6):
        g = k(g, tables)
    buf = torch.zeros(n * 16, dtype=torch.int32, device="cuda")
    k(g, tables, buf[:n])  # the copy writes [n, 8] int64 from this pointer
    torch.cuda.synchronize()
    from envpool_tpu_torch.ops.cuda_machine import machine_frame

    machine_frame(g, tables)  # load and warm the default build outside the timing
    ms_phases, _ = time_frames(k, g, tables, 10)
    ms_plain, _ = time_frames(machine_frame, g, tables, 10)
    print(f"frame 7 at {n} machines: {ms_phases:.4f} ms with clock64 phases, "
          f"{ms_plain:.4f} ms without")
    ph = buf.view(torch.int64).view(n, 8).double()
    per = ph[:, :6].mean(0)
    ins = float(ph[:, 6].mean())
    total = float(per.sum())
    print(f"phase clocks at {n} machines ({k.machines_per_warp}/warp, clock64 in every "
          f"instruction): {total:,.0f} SM clocks per machine-frame over "
          f"{ins:.0f} instructions = {total / ins:.0f} per instruction")
    for name_, c in zip(PHASES, per.tolist()):
        print(f"  {name_:>18}: {c:12,.0f} clocks = {c / ins:7.1f} per instruction "
              f"({c / total:.3f})")


def sweep_kernel(source: pathlib.Path = _SOURCE, name: str = "k2_sweep"):
    """K2 built from ``source`` with every geometry (-DK2_ALL_GEOMETRIES)."""
    from envpool_tpu_torch.ops.cuda_machine import MachineFrame

    return MachineFrame(source, _PKG / "_build" / name, name,
                        extra_cflags=("-DK2_ALL_GEOMETRIES",))


def check_against_plain(kernels: dict, mc) -> None:
    """Every geometry of every kernel against the plain frame, on every
    leaf and each machine's instruction count; raises on a difference."""
    import torch

    from envpool_tpu_torch.envs.atari import machine_kernel
    from envpool_tpu_torch.ops.cuda_machine import GEOMETRIES

    cases = [("pong", mc.pong_rom(), 257, 3), ("f8", mc.f8_rom(), 20, 2),
             ("f6", mc.f6_rom(), 20, 2), ("random0", mc.random_rom(0), 20, 1)]
    for cart, rom, n, frames in cases:
        tables = machine_kernel.build_tables(rom, "cuda")
        plain = [machines(rom, n)]
        want = torch.zeros(n, dtype=torch.int32, device="cuda")
        plain_counts = []
        for _ in range(frames):
            plain.append(machine_kernel.frame(plain[-1], tables, want))
            plain_counts.append(want.clone())
        for name, k2 in kernels.items():
            for geo in GEOMETRIES:
                k2.machines_per_warp = geo
                g = plain[0]
                got = torch.zeros(n, dtype=torch.int32, device="cuda")
                for f in range(frames):
                    g = k2(g, tables, got)
                    torch.cuda.synchronize()
                    bad = [k for k in plain[f + 1] if not torch.equal(g[k], plain[f + 1][k])]
                    if bad or not torch.equal(got, plain_counts[f]):
                        raise RuntimeError(f"{name} {geo}/warp differs from plain on "
                                           f"{cart} frame {f}: {bad or 'counts'}")
        print(f"K2 vs plain [{cart}, {n} lanes x {frames} frames]: every kernel and "
              f"geometry equal in every leaf and instruction count "
              f"(max {int(plain_counts[-1].max())} instructions)")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--wide", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--phases", action="store_true",
                    help="only the clock64 phase breakdown of one frame")
    ap.add_argument("--against", type=pathlib.Path,
                    help="another machine_frame.cu with the same interface (say, "
                         "the parent commit's), checked and timed in turns beside "
                         "this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 1
    from envpool_tpu_torch.envs.atari import machine_kernel
    from envpool_tpu_torch.ops.cuda_machine import GEOMETRIES, MACHINES_PER_WARP

    print(f"device: {torch.cuda.get_device_name(0)}; {smi('name,power.limit')}")
    mc = carts()
    if args.phases:
        phase_clocks(mc.pong_rom(), args.n)
        return 0
    sources = {"this": _SOURCE}
    if args.against:
        sources["against"] = args.against.resolve()
    kernels = {name: sweep_kernel(src, f"k2_sweep_{name}") for name, src in sources.items()}
    with ThreadPoolExecutor(len(kernels)) as pool:  # the nvcc runs overlap
        built = {name: pool.submit(k.build) for name, k in kernels.items()}
        for name, src in sources.items():
            print(f"ptxas [{name}]:\n{ptxas_report(src, _OUT, name)}")
        for name, fut in built.items():
            print(f"K2 [{name}] build with every geometry: {fut.result():.1f} s")
    check_against_plain(kernels, mc)

    clocks, ns = smem_latency(kernels["this"])
    print(f"dependent shared-memory load: {clocks:.2f} SM clocks, {ns:.3f} ns "
          f"(SM clock {smi('clocks.sm')})")

    rom = mc.pong_rom()
    tables = machine_kernel.build_tables(rom, "cuda")
    order = [(name, geo) for name in kernels for geo in GEOMETRIES]
    times: dict = {}
    for n, modes in ((args.n, (True, False)), (2 * args.n, (True,)), (args.wide, (True,))):
        warm = {}
        k2 = kernels["this"]
        for differ in modes:
            g = machines(rom, n, differ)
            k2.machines_per_warp = MACHINES_PER_WARP
            for _ in range(6):  # as bench.py: steady frames after 6
                g = k2(g, tables)
            counts = torch.zeros(n, dtype=torch.int32, device="cuda")
            k2(g, tables, counts)
            warm[differ] = g
            print(f"{n} machines, lanes {'differ' if differ else 'lockstep'}: "
                  f"instructions per machine in frame 7: max {int(counts.max())}, "
                  f"mean {float(counts.float().mean()):.1f}")
        for name, geo in order + order[::-1]:  # in turns: A B ... B A
            kernels[name].machines_per_warp = geo
            for differ in modes:
                ms, _ = time_frames(kernels[name], warm[differ], tables, args.frames)
                times.setdefault((n, name, geo, differ), []).append(ms)
        print(f"SM clock after the {n}-machine runs: {smi('clocks.sm')}")
    for (n, name, geo, differ), ms in times.items():
        print(f"timing [{name}] {n} machines {geo:2d}/warp lanes "
              f"{'differ' if differ else 'lockstep'}: "
              + ", ".join(f"{t:.4f}" for t in ms) + " ms/frame")
    print("k2_probe: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
