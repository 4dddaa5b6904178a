"""The 2600 frame: plain PyTorch version of K2.

Counterpart of ``envpool_tpu/envs/atari/machine_kernel.py``
(``step_batched``, ``_make_record``, ``_collisions``, ``_line_slot``,
``frame_batched`` and ``scatter_lines``).  :func:`frame` advances every
row of a machine batch by one video frame: up to 262 line slots, each
running instructions until the line's 76 CPU cycles are spent (at most 40),
then a 24-register record of the line, written straight into
``g["lines"]``, and the collision latches of visible lines.

The state keeps the JAX env's layout (``cpu6502.make_machine`` +
``tia.attach_tia`` under ``vmap``: ``[N]``-leading int32 tensors, ``wrapped``
bool).  None of the JAX module's TPU workarounds carry over: inside a
frame the work copy holds the ROM and every row's bus in one flat integer
tensor, and each bus read or write is one indexing op through static
address tables.

The step is written for the CPU tests: it evaluates only the addressing
modes and ops that the active rows run this step (a host-side set), so a
pong frame costs ~40 small ops per instruction instead of the union of
all 56 ops.  Rows that are not active are never changed: they keep their
state exactly, as ``step_batched``'s ``act`` mask does.

One rule of the JAX batched step is kept per row: an instruction whose PC
is at or above $1000 and below the last two bytes of a 4K window is
fetched from the cartridge at ``PC & 0xFFF`` of the current bank
(``machine_kernel.py:292-314``'s fast path), otherwise through the full
bus.  (JAX picks the path for the whole batch at once, so its result for
a PC in a mirror such as $2000-$2FFF depends on the other rows.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import cpu6502 as c
from . import tia
from .cpu6502 import CPU_TABLES
from .tia import CYCLES_PER_LINE, FIRST_VISIBLE, NREG, VISIBLE_LINES

__all__ = ["SCALARS", "SLOTS", "BUDGET", "build_tables", "collisions", "frame"]

SLOTS = FIRST_VISIBLE + VISIBLE_LINES + 30  # 262, as tia.run_frame
BUDGET = 40  # instructions per line slot (tia._LINE_BUDGET)

# Per-row scalar state, in the order K2 packs it.
SCALARS = (
    "a", "x", "y", "sp", "pc", "p", "bank", "cycles", "tia_waddr",
    "swcha", "inpt4", "scanline", "line_cycles", "posp0", "posp1",
    "posm0", "posm1", "posbl", "grp0_old", "grp1_old", "enabl_old",
    "wrapped",
)
NS = len(SCALARS)

# A row's bus block inside the work copy: RAM, collision latches, the
# read-only bytes, the TIA register file and a sink for masked writes.
_RAM, _CX, _INPT4, _C80, _SWCHA, _ZERO, _TIA, _SINK = (
    0, 128, 136, 137, 138, 139, 140, 204,
)
_W = 208

# (line-record column → TIA register) for the registers read directly.
_REC_TIA = {
    tia.R_PF0: 0x0D, tia.R_PF1: 0x0E, tia.R_PF2: 0x0F, tia.R_COLUPF: 0x08,
    tia.R_COLUBK: 0x09, tia.R_CTRLPF: 0x0A, tia.R_COLUP0: 0x06,
    tia.R_COLUP1: 0x07, tia.R_NUSIZ0: 0x04, tia.R_NUSIZ1: 0x05,
    tia.R_ENAM0: 0x1D, tia.R_ENAM1: 0x1E, tia.R_REFP0: 0x0B,
    tia.R_REFP1: 0x0C, tia.R_RESMP0: 0x28, tia.R_RESMP1: 0x29,
}


def _bus_tables():
    """Read and write slots of every bus address ``a`` in [0, $2000).

    Read: ``a >= $1000`` is the cartridge (offset ``a & 0xFFF``); below it
    RIOT RAM ($80-$FF and mirrors: A12=0, A9=0, A7=1), SWCHA at $280 and
    the TIA read map (A7=0, A9=0: ``a & 0xF`` 0-7 collision latches, $C
    INPT4, $D reads $80), else 0 (``machine_kernel._bus_nonrom``).
    Write: RAM, or the TIA register file below $40, else the sink.
    """
    a = np.arange(0x2000)
    ram = (a < 0x1000) & ((a & 0x200) == 0) & ((a & 0x80) == 0x80)
    tia_rd = (a < 0x1000) & ((a & 0x80) == 0) & ((a & 0x200) == 0)
    idx = a & 0xF
    read = np.full(0x2000, _ZERO)
    read[ram] = _RAM + (a[ram] & 0x7F)
    read[a == 0x280] = _SWCHA
    tia_slot = np.select(
        [idx < 8, idx == 0xC, idx == 0xD], [_CX + idx, _INPT4, _C80], _ZERO
    )
    read[tia_rd] = tia_slot[tia_rd]
    rom = a >= 0x1000
    read[rom] = a[rom] & 0xFFF
    write = np.full(0x2000, _SINK)
    write[ram] = _RAM + (a[ram] & 0x7F)
    write[a < 0x40] = _TIA + a[a < 0x40]
    return read, write


_READ_SLOT, _WRITE_SLOT = _bus_tables()
_MODE = CPU_TABLES[0].tolist()
_OP = CPU_TABLES[1].tolist()
_MEM_MODES = {c.ZP, c.ZPX, c.ZPY, c.ABS, c.ABX, c.ABY, c.IND, c.IZX, c.IZY}
_STORE_OPS = {c.O_STA, c.O_STX, c.O_STY, c.O_INC, c.O_DEC,
              c.O_ASL, c.O_LSR, c.O_ROL, c.O_ROR}
_BRANCH = {
    c.O_BCC: (c.F_C, 0), c.O_BCS: (c.F_C, 1), c.O_BEQ: (c.F_Z, 1),
    c.O_BNE: (c.F_Z, 0), c.O_BMI: (c.F_N, 1), c.O_BPL: (c.F_N, 0),
    c.O_BVC: (c.F_V, 0), c.O_BVS: (c.F_V, 1),
}


def build_tables(rom_np: np.ndarray, device) -> dict:
    """Per-cart tensors: the ROM image, the decode table, and per cartridge
    offset the fetch row ``meta`` (plain version) and K2's fetch word."""
    rom_np = np.asarray(rom_np, np.uint8)
    n = rom_np.shape[0]
    if n not in (4096, 8192, 16384):
        raise ValueError(f"expected a 4K/8K/16K cartridge image, got {n} B")
    dev = torch.device(device)
    decode = np.stack(CPU_TABLES, 1)
    # Per cartridge offset, the three instruction bytes within its 4K bank
    # and the decode of the first: the JAX meta row (b0, b1, b2, mode, op,
    # size, cycles, 0).  K2 reads it as one little-endian 64-bit word.
    banks = rom_np.reshape(-1, 4096).astype(np.int64)
    j = np.arange(4096)
    b0 = banks[:, j]
    meta = np.concatenate([
        np.stack([b0, banks[:, (j + 1) & 0xFFF], banks[:, (j + 2) & 0xFFF]], -1),
        decode[b0],
    ], -1).reshape(-1, 7)
    fetch = (meta << (8 * np.arange(7))).sum(-1)
    return {
        "rom": torch.as_tensor(rom_np, device=dev),
        "decode": torch.as_tensor(decode.astype(np.int32), device=dev),
        "meta": torch.as_tensor(meta, device=dev),
        "fetch": torch.as_tensor(fetch, device=dev),
        "nbanks": n // 4096,
    }


# Z and N flag bits of each byte value.
_ZN = np.arange(256, dtype=np.int64) & 0x80
_ZN[0] = 0x02


def collisions(rec: torch.Tensor) -> torch.Tensor:
    """``[N, 8]`` collision-latch contribution of line records ``[N, NREG]``.

    Bits (7, 6) per latch as the TIA read map $0-$7: CXM0P(M0·P1, M0·P0)
    CXM1P(M1·P0, M1·P1) CXP0FB(P0·PF, P0·BL) CXP1FB(P1·PF, P1·BL)
    CXM0FB(M0·PF, M0·BL) CXM1FB(M1·PF, M1·BL) CXBLPF(BL·PF) CXPPMM(P0·P1,
    M0·M1).
    """
    pf, bl, p0, p1, m0, m1 = tia.line_masks(rec)

    def hit(u, v):
        return (u & v).any(-1).to(torch.int64)

    return torch.stack([
        (hit(m0, p1) << 7) | (hit(m0, p0) << 6),
        (hit(m1, p0) << 7) | (hit(m1, p1) << 6),
        (hit(p0, pf) << 7) | (hit(p0, bl) << 6),
        (hit(p1, pf) << 7) | (hit(p1, bl) << 6),
        (hit(m0, pf) << 7) | (hit(m0, bl) << 6),
        (hit(m1, pf) << 7) | (hit(m1, bl) << 6),
        hit(bl, pf) << 7,
        (hit(p0, p1) << 7) | (hit(m0, m1) << 6),
    ], dim=1)


class _Frame:
    """Work copy of one batch for one frame (int64 scalars, flat bus)."""

    def __init__(self, g: dict, tables: dict):
        dev = g["pc"].device
        self.dev = dev
        n = g["pc"].shape[0]
        self.n = n
        rom = tables["rom"].to(torch.int64)
        self.nbanks = int(tables["nbanks"])
        self.dec = tables["decode"].to(torch.int64)
        self.meta = tables["meta"]
        self.zn = torch.as_tensor(_ZN, device=dev)
        self.no_write = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.read_slot = torch.as_tensor(_READ_SLOT, device=dev)
        self.write_slot = torch.as_tensor(_WRITE_SLOT, device=dev)
        r = rom.shape[0]
        blocks = torch.zeros((n, _W), dtype=torch.int64, device=dev)
        blocks[:, _RAM:_RAM + 128] = g["ram"]
        blocks[:, _CX:_CX + 8] = g["cx"]
        blocks[:, _INPT4] = g["inpt4"]
        blocks[:, _C80] = 0x80
        blocks[:, _SWCHA] = g["swcha"]
        blocks[:, _TIA:_TIA + 64] = g["tia"]
        self.mem = torch.cat([rom, blocks.reshape(-1)])
        self.blocks = self.mem[r:].view(n, _W)
        self.lane_base = r + torch.arange(n, device=dev) * _W
        self.s = {k: g[k].to(torch.int64) for k in SCALARS}
        self.lines = torch.cat(
            [g["lines"], torch.zeros((n, 1, NREG), dtype=g["lines"].dtype,
                                     device=dev)], dim=1,
        )
        self.rows = torch.arange(n, device=dev)
        self.k3 = torch.arange(3, device=dev)

    # -- bus -----------------------------------------------------------------

    def read(self, addr: torch.Tensor) -> torch.Tensor:
        """Bus bytes at addresses ``[N]`` or ``[N, K]`` (masked to 13 bits)."""
        a = addr & 0x1FFF
        base = torch.where(
            a >= 0x1000,
            self._col(self.s["bank"] * 4096, a),
            self._col(self.lane_base, a),
        )
        return self.mem[self.read_slot[a] + base]

    def write(self, addr, value, do):
        """Bus write for rows where ``do``: RAM or the TIA register file."""
        slot = torch.where(do, self.write_slot[addr & 0x1FFF], _SINK)
        self.mem[self.lane_base + slot] = value & 0xFF

    @staticmethod
    def _col(v, like):
        return v[:, None] if like.ndim == 2 else v

    def tia_reg(self, i):
        return self.blocks[:, _TIA + i]

    # -- one instruction ----------------------------------------------------

    def step(self, act: torch.Tensor) -> None:
        s = self.s
        pc, a, x, y, sp, p = s["pc"], s["a"], s["x"], s["y"], s["sp"], s["p"]
        every = bool(act.all())
        # Fetch and decode in one lookup of the per-offset table; rows out
        # of the window's reach read their three bytes through the bus.
        at = pc & 0xFFF
        slow = (pc < 0x1000) | (at >= 0xFFD)
        if self.nbanks > 1:
            at = at + s["bank"] * 4096
        opc, b1, b2, mode, op, size, cyc = self.meta[at].unbind(1)
        if bool(slow.any()):
            bus = self.read(pc[:, None] + self.k3)
            slow3 = slow[:, None]
            opc, b1, b2 = torch.where(slow3, bus, torch.stack([opc, b1, b2], 1)).unbind(1)
            mode, op, size, cyc = self.dec[opc].unbind(1)
        first = opc[0]
        if every and bool((opc == first).all()):
            codes = [int(first)]
        else:
            codes = torch.unique(opc[act]).tolist()
        ops = {_OP[k] for k in codes}
        modes = {_MODE[k] for k in codes}

        def pick(cases, default):
            """First-match select over (mode, value) for the modes present;
            each value is a function, evaluated only for modes present."""
            cases = [(m, f) for m, f in cases if m in modes]
            if len(cases) == 1 and len(modes) == 1:
                return cases[0][1]()
            out = default
            for m, f in reversed(cases):
                out = torch.where(mode == m, f(), out)
            return out

        def zp_word(ptr):
            lo_hi = self.read(torch.stack([ptr, (ptr + 1) & 0xFF], 1))
            return lo_hi[:, 0] | (lo_hi[:, 1] << 8)

        # Effective address per mode.
        abs_a = b1 | (b2 << 8)
        zero = torch.zeros_like(pc)
        addr = pick([
            (c.ZP, lambda: b1), (c.ZPX, lambda: (b1 + x) & 0xFF),
            (c.ZPY, lambda: (b1 + y) & 0xFF), (c.ABS, lambda: abs_a),
            (c.ABX, lambda: (abs_a + x) & 0xFFFF),
            (c.ABY, lambda: (abs_a + y) & 0xFFFF), (c.IND, lambda: abs_a),
            (c.IZX, lambda: zp_word((b1 + x) & 0xFF)),
            (c.IZY, lambda: (zp_word(b1) + y) & 0xFFFF),
        ], zero)
        mem_v = self.read(addr) if modes & _MEM_MODES else zero
        if c.IND in modes:  # JMP (ind): the vector's high byte wraps in its page
            am = abs_a & 0x1FFF
            wrap = (am & 0xFF00) | ((am + 1) & 0xFF)
            vec = self.read(torch.stack([am, wrap], 1))
            addr = torch.where(mode == c.IND, vec[:, 0] | (vec[:, 1] << 8), addr)
        v = pick([(c.IMM, lambda: b1), (c.ACC, lambda: a)], mem_v)

        single = len(ops) == 1
        new = {"a": a, "x": x, "y": y, "sp": sp, "p": p,
               "pc": (pc + size) & 0xFFFF}
        w1 = {"addr": zero, "val": zero, "do": torch.zeros_like(act)}

        def sel(o, cond=None):
            m = None if single else (op == o)
            if cond is None:
                return m
            return cond if m is None else (m & cond)

        def put(d, key, m, value):
            d[key] = value if m is None else torch.where(m, value, d[key])

        def flags(m, value):
            put(new, "p", m, value)

        def store(m, at, value):
            put(w1, "addr", m, at)
            put(w1, "val", m, value)
            put(w1, "do", m, torch.ones_like(act))

        def set_zn(byte):
            return (p & ~0x82) | self.zn[byte]

        if ops & {c.O_ADC, c.O_SBC, c.O_ROL, c.O_ROR}:
            carry = p & 1
            decimal = (p & 0x08) != 0
        pulls = None
        if ops & {c.O_PLA, c.O_PLP, c.O_RTS, c.O_RTI}:
            pulls = self.read(0x100 + ((sp[:, None] + self.k3 + 1) & 0xFF))
        for o in ops:
            m = sel(o)
            if o in (c.O_LDA, c.O_LDX, c.O_LDY):
                put(new, "axy"[(o - c.O_LDA)], m, v)
                flags(m, set_zn(v))
            elif o in (c.O_STA, c.O_STX, c.O_STY):
                store(m, addr, (a, x, y)[o - c.O_STA])
            elif o in (c.O_TAX, c.O_TAY, c.O_TXA, c.O_TYA, c.O_TSX):
                dst, src = {c.O_TAX: ("x", a), c.O_TAY: ("y", a),
                            c.O_TXA: ("a", x), c.O_TYA: ("a", y),
                            c.O_TSX: ("x", sp)}[o]
                put(new, dst, m, src)
                flags(m, set_zn(src))
            elif o == c.O_TXS:
                put(new, "sp", m, x)
            elif o in (c.O_PHA, c.O_PHP):
                store(m, 0x100 + sp, a if o == c.O_PHA else p | 0x30)
                put(new, "sp", m, (sp - 1) & 0xFF)
            elif o == c.O_PLA:
                put(new, "a", m, pulls[:, 0])
                put(new, "sp", m, (sp + 1) & 0xFF)
                flags(m, set_zn(pulls[:, 0]))
            elif o == c.O_PLP:
                put(new, "sp", m, (sp + 1) & 0xFF)
                flags(m, (pulls[:, 0] & ~0x10) | 0x20)
            elif o in (c.O_AND, c.O_ORA, c.O_EOR):
                r = (a & v, a | v, a ^ v)[o - c.O_AND]
                put(new, "a", m, r)
                flags(m, set_zn(r))
            elif o == c.O_ADC:
                total = a + v + carry
                rb = total & 0xFF
                vb = (~(a ^ v) & (a ^ total) & 0x80) != 0
                d_lo = (a & 0x0F) + (v & 0x0F) + carry
                d_hi = (a & 0xF0) + (v & 0xF0)
                lo_fix = d_lo > 0x09
                d_hi = d_hi + torch.where(lo_fix, 0x10, 0)
                d_lo = d_lo + torch.where(lo_fix, 0x06, 0)
                vd = (~(a ^ v) & (a ^ d_hi) & 0x80) != 0
                nd = (d_hi & 0x80) != 0
                d_hi = d_hi + torch.where(d_hi > 0x90, 0x60, 0)
                cd = d_hi > 0xF0
                rd = ((d_lo & 0x0F) | (d_hi & 0xF0)) & 0xFF
                put(new, "a", m, torch.where(decimal, rd, rb))
                q = set_zn(rb) & ~0xC1
                q = q | torch.where(decimal, cd, total > 0xFF).to(torch.int64)
                q = q | (torch.where(decimal, vd, vb).to(torch.int64) << 6)
                n_flag = torch.where(decimal, nd.to(torch.int64) << 7, rb & 0x80)
                flags(m, q | n_flag)
            elif o == c.O_SBC:
                sv = v ^ 0xFF
                total = a + sv + carry
                rb = total & 0xFF
                vb = (~(a ^ sv) & (a ^ total) & 0x80) != 0
                s_lo = (a & 0x0F) - (v & 0x0F) - (1 - carry)
                lo_b = (s_lo & 0x10) != 0
                s_lo = s_lo - torch.where(lo_b, 6, 0)
                s_hi = (a >> 4) - (v >> 4) - lo_b.to(torch.int64)
                s_hi = s_hi - torch.where((s_hi & 0x10) != 0, 6, 0)
                rd = ((s_lo & 0x0F) | ((s_hi & 0x0F) << 4)) & 0xFF
                put(new, "a", m, torch.where(decimal, rd, rb))
                q = set_zn(rb) & ~0x41
                flags(m, q | (total > 0xFF).to(torch.int64) | (vb.to(torch.int64) << 6))
            elif o in (c.O_CMP, c.O_CPX, c.O_CPY):
                src = (a, x, y)[o - c.O_CMP]
                q = set_zn((src - v) & 0xFF) & ~1
                flags(m, q | (src >= v).to(torch.int64))
            elif o in (c.O_INC, c.O_DEC):
                r = (mem_v + (1 if o == c.O_INC else -1)) & 0xFF
                store(m, addr, r)
                flags(m, set_zn(r))
            elif o in (c.O_INX, c.O_INY, c.O_DEX, c.O_DEY):
                key, src, d = {c.O_INX: ("x", x, 1), c.O_INY: ("y", y, 1),
                               c.O_DEX: ("x", x, -1), c.O_DEY: ("y", y, -1)}[o]
                r = (src + d) & 0xFF
                put(new, key, m, r)
                flags(m, set_zn(r))
            elif o in (c.O_ASL, c.O_LSR, c.O_ROL, c.O_ROR):
                if o == c.O_ASL:
                    r, cout = (v << 1) & 0xFF, (v >> 7) & 1
                elif o == c.O_LSR:
                    r, cout = v >> 1, v & 1
                elif o == c.O_ROL:
                    r, cout = ((v << 1) | carry) & 0xFF, (v >> 7) & 1
                else:
                    r, cout = (v >> 1) | (carry << 7), v & 1
                on_a = mode == c.ACC
                put(new, "a", sel(o, on_a), r)
                store(sel(o, ~on_a), addr, r)
                flags(m, (set_zn(r) & ~1) | cout)
            elif o == c.O_JMP:
                put(new, "pc", m, addr)
            elif o == c.O_JSR:
                ret = (pc + 2) & 0xFFFF
                store(m, 0x100 + sp, ret >> 8)
                self.write(0x100 + ((sp - 1) & 0xFF), ret,
                           act if m is None else act & m)
                put(new, "sp", m, (sp - 2) & 0xFF)
                put(new, "pc", m, abs_a)
            elif o == c.O_RTS:
                put(new, "sp", m, (sp + 2) & 0xFF)
                put(new, "pc", m, ((pulls[:, 0] | (pulls[:, 1] << 8)) + 1) & 0xFFFF)
            elif o == c.O_RTI:
                put(new, "sp", m, (sp + 3) & 0xFF)
                flags(m, (pulls[:, 0] & ~0x10) | 0x20)
                put(new, "pc", m, pulls[:, 1] | (pulls[:, 2] << 8))
            elif o in _BRANCH:
                bit, want = _BRANCH[o]
                rel = torch.where(b1 < 0x80, b1, b1 - 256)
                taken = sel(o, ((p >> bit) & 1) == want)
                put(new, "pc", taken, (new["pc"] + rel) & 0xFFFF)
            elif o == c.O_BIT:
                q = p & ~0xC2
                q = q | torch.where((a & v) == 0, 0x02, 0) | (v & 0xC0)
                flags(m, q)
            elif o in (c.O_CLC, c.O_SEC, c.O_CLD, c.O_SED, c.O_CLI, c.O_SEI,
                       c.O_CLV):
                bit, on = {c.O_CLC: (0x01, 0), c.O_SEC: (0x01, 1),
                           c.O_CLD: (0x08, 0), c.O_SED: (0x08, 1),
                           c.O_CLI: (0x04, 0), c.O_SEI: (0x04, 1),
                           c.O_CLV: (0x40, 0)}[o]
                flags(m, (p | bit) if on else (p & ~bit))
            # BRK and NOP: PC advances by the instruction size only.

        # Memory write-back (stores and pushes), then the TIA strobes.
        wrote_tia = None
        if ops & (_STORE_OPS | {c.O_PHA, c.O_PHP, c.O_JSR}):
            do = act & w1["do"]
            pre_vsync = self.tia_reg(0).clone()
            self.write(w1["addr"], w1["val"], do)
            if ops & _STORE_OPS:
                wrote_tia = do & ((w1["addr"] & 0x1FFF) < 0x40)
                if not bool(wrote_tia.any()):
                    wrote_tia = None

        # Bank switching: hotspot on a data/jump access and on the next fetch.
        bank = s["bank"]
        if self.nbanks > 1:
            hot = 0xFF8 if self.nbanks == 2 else 0xFF6
            acc = addr & 0x1FFF
            off = (acc & 0xFFF) - hot
            touches = ~((mode == c.IMP) | (mode == c.ACC) | (mode == c.IMM)
                        | (mode == c.REL))
            is_hot = (acc >= 0x1000) & (off >= 0) & (off < self.nbanks) & touches
            bank = torch.where(is_hot, off, bank)
            facc = new["pc"] & 0x1FFF
            foff = (facc & 0xFFF) - hot
            bank = torch.where(
                (facc >= 0x1000) & (foff >= 0) & (foff < self.nbanks), foff, bank
            )
        new["bank"] = bank
        for k, val in new.items():
            if val is not s[k]:
                s[k] = val if every else torch.where(act, val, s[k])
        step_cyc = cyc if every else torch.where(act, cyc, 0)
        s["cycles"] = s["cycles"] + step_cyc
        s["line_cycles"] = s["line_cycles"] + step_cyc
        if wrote_tia is None:
            s["tia_waddr"] = (
                self.no_write if every else torch.where(act, -1, s["tia_waddr"])
            )
        else:
            self._beam(torch.where(wrote_tia, w1["addr"] & 0x1FFF, -1),
                       act, pre_vsync)
        if self.resmp:
            self._center_missiles(act)

    # -- TIA beam bookkeeping (tia._instr) -----------------------------------

    def _beam(self, wrote, act, pre_vsync) -> None:
        s = self.s
        t = self.tia_reg
        s["tia_waddr"] = torch.where(act, wrote, s["tia_waddr"])
        # VDEL cross-latch: GRP0 writes copy GRP1 → old GRP1; GRP1 writes
        # copy GRP0 → old GRP0 and ENABL → old ENABL.
        s["grp1_old"] = torch.where(wrote == 0x1B, t(0x1C), s["grp1_old"])
        s["grp0_old"] = torch.where(wrote == 0x1C, t(0x1B), s["grp0_old"])
        s["enabl_old"] = torch.where(wrote == 0x1C, t(0x1F), s["enabl_old"])
        beam = torch.clamp(s["line_cycles"] * 3 - 68, 0, 159)
        hmove = wrote == 0x2A
        for i, k in enumerate(("posp0", "posp1", "posm0", "posm1", "posbl")):
            pos = torch.where(wrote == 0x10 + i, beam, s[k])
            nib = (t(0x20 + i) >> 4) & 0xF
            motion = torch.where(nib >= 8, nib - 16, nib)
            s[k] = torch.where(hmove, (pos - motion) % 160, pos)
        hmclr = (wrote == 0x2B)[:, None]
        hm = self.blocks[:, _TIA + 0x20:_TIA + 0x25]
        hm.copy_(torch.where(hmclr, 0, hm))
        s["line_cycles"] = torch.where(wrote == 0x02, CYCLES_PER_LINE, s["line_cycles"])
        cx = self.blocks[:, _CX:_CX + 8]
        cx.copy_(torch.where((wrote == 0x2C)[:, None], 0, cx))
        vsync_off = (wrote == 0x00) & ((pre_vsync & 2) != 0) & ((t(0) & 2) == 0)
        s["wrapped"] = s["wrapped"] | (vsync_off & (s["scanline"] > 3)).to(torch.int64)
        s["scanline"] = torch.where(vsync_off, 3, s["scanline"])
        self.resmp = bool((((t(0x28) | t(0x29)) & 2) != 0).any())

    def _center_missiles(self, act) -> None:
        """RESMP: the missile tracks its player's center (pos + 4·scale)."""
        s, t = self.s, self.tia_reg
        for m, pl, nus, res in (("posm0", "posp0", 0x04, 0x28),
                                ("posm1", "posp1", 0x05, 0x29)):
            mode7 = t(nus) & 7
            scale = torch.where(mode7 == 5, 2, torch.where(mode7 == 7, 4, 1))
            on = act & ((t(res) & 2) != 0)
            s[m] = torch.where(on, (s[pl] + 4 * scale) % 160, s[m])

    # -- line and frame structure --------------------------------------------

    def record(self) -> torch.Tensor:
        """``[N, NREG]`` display-register snapshot with VDEL resolution."""
        s, t = self.s, self.tia_reg
        cols = [None] * NREG
        for col, reg in _REC_TIA.items():
            cols[col] = t(reg)
        cols[tia.R_GRP0] = torch.where((t(0x25) & 1) != 0, s["grp0_old"], t(0x1B))
        cols[tia.R_GRP1] = torch.where((t(0x26) & 1) != 0, s["grp1_old"], t(0x1C))
        cols[tia.R_ENABL] = torch.where((t(0x27) & 1) != 0, s["enabl_old"], t(0x1F))
        for col, k in ((tia.R_POSP0, "posp0"), (tia.R_POSP1, "posp1"),
                       (tia.R_POSM0, "posm0"), (tia.R_POSM1, "posm1"),
                       (tia.R_POSBL, "posbl")):
            cols[col] = s[k]
        return torch.stack(cols, 1)

    def run(self) -> None:
        s = self.s
        self.instructions = torch.zeros_like(s["pc"])
        s["scanline"] = torch.zeros_like(s["scanline"])
        s["wrapped"] = torch.zeros_like(s["wrapped"])
        self.resmp = bool((((self.tia_reg(0x28) | self.tia_reg(0x29)) & 2) != 0).any())
        live = torch.ones(self.n, dtype=torch.bool, device=self.dev)
        for _ in range(SLOTS):
            count = torch.zeros_like(s["pc"])
            while True:
                act = live & (s["line_cycles"] < CYCLES_PER_LINE) & (count < BUDGET)
                if not bool(act.any()):
                    break
                self.step(act)
                count.add_(act)
            self.instructions.add_(count)
            # Close the line: snapshot, collision OR on visible lines, advance.
            vis = s["scanline"] - FIRST_VISIBLE
            keep = live & (vis >= 0) & (vis < VISIBLE_LINES)
            if bool(keep.any()):
                rec = self.record()
                cx = self.blocks[:, _CX:_CX + 8]
                cx.copy_(torch.where(keep[:, None], cx | collisions(rec), cx))
                row = torch.where(keep, vis, VISIBLE_LINES)
                self.lines[self.rows, row] = rec.to(self.lines.dtype)
            s["scanline"] = torch.where(live, s["scanline"] + 1, s["scanline"])
            s["line_cycles"] = torch.where(
                live, s["line_cycles"] - CYCLES_PER_LINE, s["line_cycles"]
            )
            live = live & (s["wrapped"] == 0) & (s["scanline"] < SLOTS)
            if not bool(live.any()):
                break

    def result(self, g: dict) -> dict:
        out = dict(g)
        for k in SCALARS:
            v = self.s[k]
            if k == "cycles":  # int32 wrap-around, as JAX lets it wrap
                v = ((v + 2**31) % 2**32) - 2**31
            out[k] = v.to(g[k].dtype)
        out["ram"] = self.blocks[:, _RAM:_RAM + 128].to(g["ram"].dtype)
        out["tia"] = self.blocks[:, _TIA:_TIA + 64].to(g["tia"].dtype)
        out["cx"] = self.blocks[:, _CX:_CX + 8].to(g["cx"].dtype)
        out["lines"] = self.lines[:, :VISIBLE_LINES].contiguous()
        return out


def frame(g: dict, tables: dict, counts: torch.Tensor | None = None) -> dict:
    """Advance every row one video frame (plain version of K2).

    ``g`` is a machine batch in the JAX env's layout; returns a new dict
    (the input is not written).  ``tables`` comes from
    :func:`build_tables`.  Given ``counts`` (``[N]``), each row's number of
    emulated instructions in the frame is written there.
    """
    f = _Frame(g, tables)
    f.run()
    if counts is not None:
        counts.copy_(f.instructions)
    return f.result(g)
