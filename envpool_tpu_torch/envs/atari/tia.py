"""TIA constants, beam state and the register-records → pixels render.

Counterpart of ``envpool_tpu/envs/atari/tia.py``: the register indices of
a line record, ``attach_tia`` and ``render_frame`` with its object masks
and luma map, batched over ``[N, ...]`` tensors.  The per-instruction beam
bookkeeping (WSYNC, RESPx, HMOVE, VDEL, VSYNC resync) is part of the frame
kernel: ``machine_kernel.py`` (plain) and ``csrc/machine_frame.cu`` (K2).
"""

from __future__ import annotations

import torch

__all__ = ["attach_tia", "line_masks", "render_frame"]

VISIBLE_LINES = 192
FIRST_VISIBLE = 40      # 3 vsync + 37 vblank lines
CYCLES_PER_LINE = 76

# Snapshot register layout: indices into the [NREG] per-line record.
R_PF0, R_PF1, R_PF2, R_COLUPF, R_COLUBK, R_CTRLPF = 0, 1, 2, 3, 4, 5
R_COLUP0, R_COLUP1, R_GRP0, R_GRP1, R_POSP0, R_POSP1 = 6, 7, 8, 9, 10, 11
R_NUSIZ0, R_NUSIZ1, R_ENAM0, R_ENAM1, R_ENABL = 12, 13, 14, 15, 16
R_POSM0, R_POSM1, R_POSBL = 17, 18, 19
R_REFP0, R_REFP1, R_RESMP0, R_RESMP1 = 20, 21, 22, 23
NREG = 24

# Beam-state scalars attach_tia adds, all int32 and 0 at power-on.
BEAM_SCALARS = (
    "scanline", "line_cycles", "posp0", "posp1", "posm0", "posm1", "posbl",
    "grp0_old", "grp1_old", "enabl_old",
)


def attach_tia(m: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Add TIA beam state to a batch of 6502 machines (``[N]`` rows)."""
    n = m["pc"].shape[0]
    dev = m["pc"].device
    out = dict(m)
    for k in BEAM_SCALARS:
        out[k] = torch.zeros(n, dtype=torch.int32, device=dev)
    # Collision latches CXM0P..CXPPMM ($0-$7), bits 7/6 as on hardware.
    out["cx"] = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    # Sticky frame-wrap flag (VSYNC pulse ended while mid-frame).
    out["wrapped"] = torch.zeros(n, dtype=torch.bool, device=dev)
    out["lines"] = torch.zeros(
        (n, VISIBLE_LINES, NREG), dtype=torch.int32, device=dev
    )
    return out


def _pf_tables(device):
    """Per pixel: which PF register (0, 1, 2) and which bit shows there,
    for the repeated ([0]) and the reflected ([1]) right half."""
    x = torch.arange(160, device=device)
    left = x >> 2
    regs, shifts = [], []
    for reflect in (False, True):
        right = (39 - left) if reflect else (left - 20)
        bit = torch.where(left < 20, left, right)
        # Bit order: PF0 bits 4-7 (left to right), PF1 bits 7-0, PF2 0-7.
        reg = torch.where(bit < 4, 0, torch.where(bit < 12, 1, 2))
        sh = torch.where(bit < 4, bit + 4, torch.where(bit < 12, 11 - bit, bit - 12))
        regs.append(reg)
        shifts.append(sh)
    return torch.stack(regs), torch.stack(shifts)


def line_masks(rec: torch.Tensor):
    """Object masks ``[..., 160]`` bool from records ``[..., NREG]``:
    (playfield, ball, player 0, player 1, missile 0, missile 1)."""
    x = torch.arange(160, device=rec.device)

    def r(i):
        return rec[..., i : i + 1]

    regs, shifts = _pf_tables(rec.device)
    reflect = (r(R_CTRLPF) & 1).long()  # [..., 1]
    reg = regs[reflect.squeeze(-1)]     # [..., 160]
    sh = shifts[reflect.squeeze(-1)]
    pf_regs = rec[..., R_PF0 : R_PF2 + 1]
    pf = ((torch.gather(pf_regs, -1, reg) >> sh) & 1) != 0

    def player(grp, pos, nusiz, refp):
        mode7 = nusiz & 7
        lgs = torch.where(mode7 == 5, 1, torch.where(mode7 == 7, 2, 0))
        has = (
            torch.ones_like(mode7, dtype=torch.bool),        # +0
            (mode7 == 1) | (mode7 == 3),                     # +16
            (mode7 == 2) | (mode7 == 3) | (mode7 == 6),      # +32
            (mode7 == 4) | (mode7 == 6),                     # +64
        )
        mirrored = (refp & 0x08) != 0
        on = torch.zeros(x.shape, dtype=torch.bool, device=rec.device)
        for c, off in enumerate((0, 16, 32, 64)):
            rel = x - pos - off
            inside = (rel >= 0) & (rel < (8 << lgs))
            bitidx = torch.clamp(rel >> lgs, 0, 7)
            bit = torch.where(mirrored, bitidx, 7 - bitidx)
            on = on | (has[c] & inside & (((grp >> bit) & 1) != 0))
        return on

    def missile(enam, pos, nusiz, resmp):
        rel = x - pos
        on = ((enam & 2) != 0) & (rel >= 0) & (rel < (1 << ((nusiz >> 4) & 3)))
        # RESMP bit 1: missile hidden while locked to the player center.
        return on & ((resmp & 2) == 0)

    rel = x - r(R_POSBL)
    bl = ((r(R_ENABL) & 2) != 0) & (rel >= 0) & (
        rel < (1 << ((r(R_CTRLPF) >> 4) & 3))
    )
    p0 = player(r(R_GRP0), r(R_POSP0), r(R_NUSIZ0), r(R_REFP0))
    p1 = player(r(R_GRP1), r(R_POSP1), r(R_NUSIZ1), r(R_REFP1))
    m0 = missile(r(R_ENAM0), r(R_POSM0), r(R_NUSIZ0), r(R_RESMP0))
    m1 = missile(r(R_ENAM1), r(R_POSM1), r(R_NUSIZ1), r(R_RESMP1))
    return pf, bl, p0, p1, m0, m1


def _luma(color: torch.Tensor) -> torch.Tensor:
    """NTSC color byte → gray level (luma bits 1-3 scaled to 0..255)."""
    return ((color >> 1) & 0x07) * 36


def render_frame(lines: torch.Tensor) -> torch.Tensor:
    """``[N, 192, NREG]`` register records → ``[N, 192, 160]`` uint8 gray.

    Hardware priority: P0/M0 over P1/M1 over BL/PF over background, unless
    CTRLPF bit 2 (PFP) lifts PF/BL above the players; CTRLPF bit 1 (score
    mode) paints the playfield halves in the player colors.
    """
    rec = lines[:, :VISIBLE_LINES]
    pf, bl, p0, p1, m0, m1 = line_masks(rec)
    x = torch.arange(160, device=rec.device)

    def r(i):
        return rec[..., i : i + 1]

    ctrl = r(R_CTRLPF)
    score = ((ctrl & 2) != 0) & ((ctrl & 4) == 0)
    pfp = (ctrl & 4) != 0
    c0, c1, cpf = _luma(r(R_COLUP0)), _luma(r(R_COLUP1)), _luma(r(R_COLUPF))
    pf_col = torch.where(score, torch.where(x < 80, c0, c1), cpf)
    bk = _luma(r(R_COLUBK)).expand(pf.shape)

    def put(px, mask, col):
        return torch.where(mask, col, px)

    # Normal: BK < PF < BL < P1/M1 < P0/M0.
    norm = put(put(put(put(put(put(
        bk, pf, pf_col), bl, cpf), p1, c1), m1, c1), p0, c0), m0, c0)
    # PFP: BK < P1/M1 < P0/M0 < PF < BL.
    front = put(put(put(put(put(put(
        bk, p1, c1), m1, c1), p0, c0), m0, c0), pf, pf_col), bl, cpf)
    frame = torch.where(pfp, front, norm)
    return torch.clamp(frame, 0, 255).to(torch.uint8)
