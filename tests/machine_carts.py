"""Hand-built 2600 cartridges for the port's Machine2600 tests and smoke run.

No ROM asset ships with the repository, so the emulator is driven by
carts made here from numpy alone:

* :func:`pong_rom`: the playable pong-like cart of ``test_machine_game``;
* :func:`f8_rom`: the 8K F8 cart of ``test_machine_kernel``
  (``test_banked_rom_lockstep``): boot in bank 1, a data-access hotspot
  to bank 0, a WSYNC loop there;
* :func:`f6_rom`: a 16K F6 trampoline: banks 0-2 run one line each and
  hop to the next bank through a data-access hotspot, calling a
  subroutine and taking ``JMP (ind)`` through RAM and through a ROM
  vector that wraps in its page on the way; bank 3 now and then jumps into the $FFF6
  hotspot, which switches on both the jump access and the fetch;
* :func:`random_rom`: streams of official opcodes with random operands (the
  generator of ``test_cpu6502.test_fuzz_official_streams``), which reach
  decimal mode, RAM and TIA execution and the 4K window's edge.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_machine_game import _pong_rom  # noqa: E402

# The 6502 decode table (mode, op, size) of envpool_tpu/envs/atari/cpu6502.py
# is needed for random streams; the port's copy imports no JAX.
from envpool_tpu_torch.envs.atari.cpu6502 import CPU_TABLES, O_NOP  # noqa: E402


def pong_rom() -> np.ndarray:
    return _pong_rom()


def f8_rom() -> np.ndarray:
    rom = np.zeros(8192, np.uint8)

    def put(bank, at, bs):
        rom[bank * 4096 + at : bank * 4096 + at + len(bs)] = bs

    # Bank 1 boot: set COLUBK, strobe WSYNC in a loop, swap to bank 0.
    put(1, 0x000, [
        0xA9, 0x30, 0x85, 0x09,        # LDA #$30, STA COLUBK
        0xA9, 0x02, 0x85, 0x00,        # VSYNC on
        0x85, 0x02, 0x85, 0x02, 0x85, 0x02,  # 3x WSYNC
        0xA9, 0x00, 0x85, 0x00,        # VSYNC off
        0xAD, 0xF8, 0xFF,              # LDA $FFF8 -> bank 0
    ])
    # Bank 0 at the same continuation address: WSYNC spin + jump back.
    cont = 21
    put(0, cont, [0x85, 0x02, 0x4C, (0xF000 + cont) & 0xFF,
                  ((0xF000 + cont) >> 8) & 0xFF])
    put(1, 0xFFC, [0x00, 0xF0])
    put(0, 0xFFC, [0x00, 0xF0])
    return rom


def f6_rom() -> np.ndarray:
    rom = np.zeros(16384, np.uint8)

    def put(bank, at, bs):
        rom[bank * 4096 + at : bank * 4096 + at + len(bs)] = bs

    def jmp(at):
        return [0x4C, (0xF000 + at) & 0xFF, (0xF000 + at) >> 8]

    cont, sub, cont3 = 0x20, 0x40, 0x60
    # Bank 0 boot: playfield, ball, one VSYNC pulse, then the line loop.
    put(0, 0x000, [
        0xA9, 0x21, 0x85, 0x0A,        # CTRLPF: reflect, ball 4 px
        0xA9, 0x02, 0x85, 0x1F,        # ENABL
        0x85, 0x00, 0x85, 0x02,        # VSYNC on, WSYNC
        0xA9, 0x00, 0x85, 0x00,        # VSYNC off
        0xA9, cont, 0x85, 0x90,        # vector $90/$91 = cont
        0xA9, 0xF0, 0x85, 0x91,
        0x6C, 0x90, 0x00,              # JMP ($0090): a vector in RAM
    ])
    for bank in range(4):
        put(bank, sub, [0xA5, 0x80, 0x85, 0x1B, 0x60])  # LDA $80; STA GRP0; RTS
        put(bank, 0xFFC, [0x00, 0xF0])
    # Banks 0-2: one line each, then a data-access hotspot to the next
    # bank; the next fetch continues at the same offset there.
    for bank in range(3):
        put(bank, cont, [
            0x85, 0x02,                        # STA WSYNC
            0xA9, 0x10 * (bank + 1) | 0x0E,    # LDA #color
            0x85, 0x09, 0x85, 0x0D,            # STA COLUBK, STA PF0
            0xE6, 0x80,                        # INC $80
            0x20, sub, 0xF0,                   # JSR sub
            0xAD, 0xF7 + bank, 0xFF,           # LDA $FFF7+bank -> bank+1
        ] + jmp(cont))
    # Bank 1 closes bank 0's line with JMP ($F0FF): the vector's high byte
    # comes from $F000, as the 6502 wraps within the page.
    put(1, cont + 16, [0x6C, 0xFF, 0xF0])
    put(1, 0x0FF, [cont])
    put(1, 0x000, [0xF0])
    # Bank 3 enters at cont + 16 and runs its own loop at cont3.  Every
    # 8th visit it jumps to $1FF6 (bank 0 by the jump access and again by
    # the fetch; bank 0 holds JMP cont there), else LDA $FFF6 -> bank 0.
    put(3, cont + 16, jmp(cont3))
    body = [
        0x85, 0x02, 0xA9, 0x4E, 0x85, 0x09,   # STA WSYNC; LDA #$4E; STA COLUBK
        0xE6, 0x81, 0xA5, 0x81, 0x29, 0x07,   # INC $81; LDA $81; AND #$07
        0xD0, 0x03,                           # BNE +3
        0x4C, 0xF6, 0x1F,                     # JMP $1FF6
        0xAD, 0xF6, 0xFF,                     # LDA $FFF6 -> bank 0
    ]
    put(3, cont3, body)
    put(0, cont3 + len(body), jmp(cont))
    put(0, 0xFF6, jmp(cont))
    return rom


def random_rom(seed: int) -> np.ndarray:
    """A 4K cart of official-opcode streams with random operands."""
    official = np.flatnonzero(np.asarray(CPU_TABLES[1]) != O_NOP)
    official = official[official != 0x00]  # BRK is a halt-NOP here
    sizes = np.asarray(CPU_TABLES[2])
    rng = np.random.default_rng(100 + seed)
    rom = rng.integers(0, 256, 4096).astype(np.uint8)
    pos = 0
    while pos < 3500:
        op = int(rng.choice(official))
        rom[pos] = op
        for k in range(1, int(sizes[op])):
            rom[pos + k] = rng.integers(0, 256)
        pos += int(sizes[op])
    rom[0xFFC] = 0x00
    rom[0xFFD] = 0xF0
    return rom


def lane_inputs(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane SWCHA (random P0 direction nibble) and INPT4 bytes."""
    rng = np.random.default_rng(seed)
    swcha = (0xFF ^ (rng.integers(0, 16, n) << 4)).astype(np.int32)
    inpt4 = rng.choice([0x00, 0x80], n).astype(np.int32)
    return swcha, inpt4
