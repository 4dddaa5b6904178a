"""6502 decode tables and the batched power-on state of a 2600 machine.

Counterpart of ``envpool_tpu/envs/atari/cpu6502.py``: the addressing-mode,
op and flag constants, the numpy decode tables (``_build_tables`` /
``CPU_TABLES``, copied) and ``make_machine`` as a batched init over ``N``
rows.  The instruction semantics live in ``machine_kernel.py`` (plain
PyTorch) and ``csrc/machine_frame.cu`` (K2); the scalar
``step_instruction`` / ``run`` of the JAX module are not on the port's path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CPU_TABLES", "make_machine"]

# Addressing modes.
IMP, ACC, IMM, ZP, ZPX, ZPY, ABS, ABX, ABY, IND, IZX, IZY, REL = range(13)

# Operations (op ids).
(
    O_LDA, O_LDX, O_LDY, O_STA, O_STX, O_STY, O_TAX, O_TAY, O_TXA, O_TYA,
    O_TSX, O_TXS, O_PHA, O_PHP, O_PLA, O_PLP, O_AND, O_ORA, O_EOR, O_ADC,
    O_SBC, O_CMP, O_CPX, O_CPY, O_INC, O_INX, O_INY, O_DEC, O_DEX, O_DEY,
    O_ASL, O_LSR, O_ROL, O_ROR, O_JMP, O_JSR, O_RTS, O_BCC, O_BCS, O_BEQ,
    O_BMI, O_BNE, O_BPL, O_BVC, O_BVS, O_BIT, O_BRK, O_RTI, O_CLC, O_CLD,
    O_CLI, O_CLV, O_SEC, O_SED, O_SEI, O_NOP,
) = range(56)

# Flag bit positions in P.
F_C, F_Z, F_I, F_D, F_B, F_U, F_V, F_N = 0, 1, 2, 3, 4, 5, 6, 7


def _build_tables():
    """(mode[256], op[256], size[256], cycles[256]) int32 numpy tables."""
    mode = np.full(256, IMP, np.int32)
    op = np.full(256, O_NOP, np.int32)
    cyc = np.full(256, 2, np.int32)

    def put(code, o, m, c):
        op[code] = o
        mode[code] = m
        cyc[code] = c

    # Load/store.
    for o, codes in (
        (O_LDA, [(0xA9, IMM, 2), (0xA5, ZP, 3), (0xB5, ZPX, 4),
                 (0xAD, ABS, 4), (0xBD, ABX, 4), (0xB9, ABY, 4),
                 (0xA1, IZX, 6), (0xB1, IZY, 5)]),
        (O_LDX, [(0xA2, IMM, 2), (0xA6, ZP, 3), (0xB6, ZPY, 4),
                 (0xAE, ABS, 4), (0xBE, ABY, 4)]),
        (O_LDY, [(0xA0, IMM, 2), (0xA4, ZP, 3), (0xB4, ZPX, 4),
                 (0xAC, ABS, 4), (0xBC, ABX, 4)]),
        (O_STA, [(0x85, ZP, 3), (0x95, ZPX, 4), (0x8D, ABS, 4),
                 (0x9D, ABX, 5), (0x99, ABY, 5), (0x81, IZX, 6),
                 (0x91, IZY, 6)]),
        (O_STX, [(0x86, ZP, 3), (0x96, ZPY, 4), (0x8E, ABS, 4)]),
        (O_STY, [(0x84, ZP, 3), (0x94, ZPX, 4), (0x8C, ABS, 4)]),
        (O_AND, [(0x29, IMM, 2), (0x25, ZP, 3), (0x35, ZPX, 4),
                 (0x2D, ABS, 4), (0x3D, ABX, 4), (0x39, ABY, 4),
                 (0x21, IZX, 6), (0x31, IZY, 5)]),
        (O_ORA, [(0x09, IMM, 2), (0x05, ZP, 3), (0x15, ZPX, 4),
                 (0x0D, ABS, 4), (0x1D, ABX, 4), (0x19, ABY, 4),
                 (0x01, IZX, 6), (0x11, IZY, 5)]),
        (O_EOR, [(0x49, IMM, 2), (0x45, ZP, 3), (0x55, ZPX, 4),
                 (0x4D, ABS, 4), (0x5D, ABX, 4), (0x59, ABY, 4),
                 (0x41, IZX, 6), (0x51, IZY, 5)]),
        (O_ADC, [(0x69, IMM, 2), (0x65, ZP, 3), (0x75, ZPX, 4),
                 (0x6D, ABS, 4), (0x7D, ABX, 4), (0x79, ABY, 4),
                 (0x61, IZX, 6), (0x71, IZY, 5)]),
        (O_SBC, [(0xE9, IMM, 2), (0xE5, ZP, 3), (0xF5, ZPX, 4),
                 (0xED, ABS, 4), (0xFD, ABX, 4), (0xF9, ABY, 4),
                 (0xE1, IZX, 6), (0xF1, IZY, 5)]),
        (O_CMP, [(0xC9, IMM, 2), (0xC5, ZP, 3), (0xD5, ZPX, 4),
                 (0xCD, ABS, 4), (0xDD, ABX, 4), (0xD9, ABY, 4),
                 (0xC1, IZX, 6), (0xD1, IZY, 5)]),
        (O_CPX, [(0xE0, IMM, 2), (0xE4, ZP, 3), (0xEC, ABS, 4)]),
        (O_CPY, [(0xC0, IMM, 2), (0xC4, ZP, 3), (0xCC, ABS, 4)]),
        (O_INC, [(0xE6, ZP, 5), (0xF6, ZPX, 6), (0xEE, ABS, 6),
                 (0xFE, ABX, 7)]),
        (O_DEC, [(0xC6, ZP, 5), (0xD6, ZPX, 6), (0xCE, ABS, 6),
                 (0xDE, ABX, 7)]),
        (O_ASL, [(0x0A, ACC, 2), (0x06, ZP, 5), (0x16, ZPX, 6),
                 (0x0E, ABS, 6), (0x1E, ABX, 7)]),
        (O_LSR, [(0x4A, ACC, 2), (0x46, ZP, 5), (0x56, ZPX, 6),
                 (0x4E, ABS, 6), (0x5E, ABX, 7)]),
        (O_ROL, [(0x2A, ACC, 2), (0x26, ZP, 5), (0x36, ZPX, 6),
                 (0x2E, ABS, 6), (0x3E, ABX, 7)]),
        (O_ROR, [(0x6A, ACC, 2), (0x66, ZP, 5), (0x76, ZPX, 6),
                 (0x6E, ABS, 6), (0x7E, ABX, 7)]),
        (O_BIT, [(0x24, ZP, 3), (0x2C, ABS, 4)]),
        (O_JMP, [(0x4C, ABS, 3), (0x6C, IND, 5)]),
        (O_JSR, [(0x20, ABS, 6)]),
    ):
        for code, m, c in codes:
            put(code, o, m, c)

    # Implied / single-byte.
    for code, o, c in (
        (0xAA, O_TAX, 2), (0xA8, O_TAY, 2), (0x8A, O_TXA, 2),
        (0x98, O_TYA, 2), (0xBA, O_TSX, 2), (0x9A, O_TXS, 2),
        (0x48, O_PHA, 3), (0x08, O_PHP, 3), (0x68, O_PLA, 4),
        (0x28, O_PLP, 4), (0xE8, O_INX, 2), (0xC8, O_INY, 2),
        (0xCA, O_DEX, 2), (0x88, O_DEY, 2), (0x60, O_RTS, 6),
        (0x00, O_BRK, 7), (0x40, O_RTI, 6), (0x18, O_CLC, 2),
        (0xD8, O_CLD, 2), (0x58, O_CLI, 2), (0xB8, O_CLV, 2),
        (0x38, O_SEC, 2), (0xF8, O_SED, 2), (0x78, O_SEI, 2),
        (0xEA, O_NOP, 2),
    ):
        put(code, o, IMP, c)

    # Branches (relative).
    for code, o in (
        (0x90, O_BCC), (0xB0, O_BCS), (0xF0, O_BEQ), (0x30, O_BMI),
        (0xD0, O_BNE), (0x10, O_BPL), (0x50, O_BVC), (0x70, O_BVS),
    ):
        put(code, o, REL, 2)

    size = np.ones(256, np.int32)
    size[(mode == IMM) | (mode == ZP) | (mode == ZPX) | (mode == ZPY)
         | (mode == IZX) | (mode == IZY) | (mode == REL)] = 2
    size[(mode == ABS) | (mode == ABX) | (mode == ABY) | (mode == IND)] = 3
    size[(mode == IMP) | (mode == ACC)] = 1
    return mode, op, size, cyc


CPU_TABLES = _build_tables()


def make_machine(rom: np.ndarray, n: int, device) -> dict[str, torch.Tensor]:
    """Fresh state of ``n`` machines (PC ← reset vector of the start bank).

    ROM sizes: 4K (plain), 8K (F8, powers up in bank 1 as on Stella), 16K
    (F6, powers up in bank 0).  Keys, dtypes and ``[n]``-leading shapes are
    those of the JAX ``make_machine`` under ``vmap``.
    """
    rom = np.asarray(rom, np.uint8)
    size = rom.shape[0]
    if size not in (4096, 8192, 16384):
        raise ValueError(f"expected a 4K/8K/16K cartridge image, got {size} B")
    nbanks = size // 4096
    start_bank = 1 if nbanks == 2 else 0
    base = start_bank * 4096
    pc = int(rom[base + 0xFFC]) | (int(rom[base + 0xFFD]) << 8)

    def full(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    return {
        "bank": full(start_bank),
        "a": full(0),
        "x": full(0),
        "y": full(0),
        "sp": full(0xFD),
        "pc": full(pc),
        "p": full((1 << F_U) | (1 << F_I)),
        "ram": torch.zeros((n, 128), dtype=torch.int32, device=device),
        "tia": torch.zeros((n, 64), dtype=torch.int32, device=device),
        "tia_waddr": full(-1),  # last TIA write this instruction
        "swcha": full(0xFF),  # joystick byte (active-low)
        "inpt4": full(0x80),  # P0 fire button, bit 7 active-low
        "cycles": full(0),
    }
