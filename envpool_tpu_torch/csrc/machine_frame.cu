// K2 on Hopper: one whole video frame of every Atari 2600 machine.
//
// Replaces the Pallas TPU kernel envpool_tpu/envs/atari/machine_pallas.py
// ::_kernel (driven by frame_pallas; its body is machine_kernel._line_slot,
// step_batched, _make_record and _collisions) and fuses the XLA step that
// followed it, scatter_lines: each visible line's 24-register record is
// written straight into the [N, 192, 24] lines buffer.  The plain PyTorch
// version is envpool_tpu_torch/envs/atari/machine_kernel.py::frame.
//
// Per machine: up to 262 line slots; each runs instructions while the
// line's CPU cycles are below 76 and fewer than 40 ran, then closes the
// line (record, collision latches on visible lines, scanline + 1, line
// cycles - 76).  The frame ends after the slot in which VSYNC wrapped the
// beam or scanline reached 262.
//
// Bound: neither bytes nor arithmetic rate.  Device memory sees only the
// state in and out and 192 * 24 * 4 bytes of lines per machine; the cart
// is read once per block.  What bounds the kernel is the serial chain of
// emulated instructions of one machine (~4k per frame on the pong cart),
// each a dependent sequence of decode, shared-memory reads and a switch,
// with only N threads in flight.  The design keeps that chain short: one
// thread per machine; its registers in registers; the cart, the decode
// table and every machine's RAM, TIA register file and collision latches
// in shared memory (byte-major, so a warp in lockstep touches one word per
// address); blocks of 32 threads so that N = 1024 machines spread over 32
// SMs instead of crowding a few.  Collisions use the bit-parallel words of
// machine_kernel._pf_words / _player_words: each object's 160-pixel line
// is five 32-bit words, and a pair test is five ANDs.
//
// Arithmetic is unsigned where it may wrap (cycles), as JAX lets int32
// wrap; shifts never take negative amounts.
//
// Plain C interface, loaded with ctypes: the wrapper checks shapes, dtypes,
// devices and contiguity before it calls machine_frame_launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kSlots = 262;
constexpr int kBudget = 40;
constexpr int kFirstVisible = 40;
constexpr int kVisible = 192;
constexpr int kNReg = 24;
constexpr int kCyclesPerLine = 76;

// Scalar rows of the packed [NS, N] state: machine_kernel.SCALARS order.
enum Scalar {
  S_A, S_X, S_Y, S_SP, S_PC, S_P, S_BANK, S_CYCLES, S_WADDR, S_SWCHA,
  S_INPT4, S_SCANLINE, S_LINE_CYCLES, S_POSP0, S_POSP1, S_POSM0, S_POSM1,
  S_POSBL, S_GRP0_OLD, S_GRP1_OLD, S_ENABL_OLD, S_WRAPPED, NS
};

// Addressing modes and ops: cpu6502.py order.
enum Mode { IMP, ACC, IMM, ZP, ZPX, ZPY, ABS, ABX, ABY, IND, IZX, IZY, REL };
enum Op {
  O_LDA, O_LDX, O_LDY, O_STA, O_STX, O_STY, O_TAX, O_TAY, O_TXA, O_TYA,
  O_TSX, O_TXS, O_PHA, O_PHP, O_PLA, O_PLP, O_AND, O_ORA, O_EOR, O_ADC,
  O_SBC, O_CMP, O_CPX, O_CPY, O_INC, O_INX, O_INY, O_DEC, O_DEX, O_DEY,
  O_ASL, O_LSR, O_ROL, O_ROR, O_JMP, O_JSR, O_RTS, O_BCC, O_BCS, O_BEQ,
  O_BMI, O_BNE, O_BPL, O_BVC, O_BVS, O_BIT, O_BRK, O_RTI, O_CLC, O_CLD,
  O_CLI, O_CLV, O_SEC, O_SED, O_SEI, O_NOP
};

constexpr uint32_t F_C = 0x01, F_Z = 0x02, F_I = 0x04, F_D = 0x08,
                   F_B = 0x10, F_U = 0x20, F_V = 0x40, F_N = 0x80;

// ---------------------------------------------------------------------------
// Collision words (machine_kernel._rev8 ... _collisions)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rev8(uint32_t x) {
  x = ((x & 0xF0u) >> 4) | ((x & 0x0Fu) << 4);
  x = ((x & 0xCCu) >> 2) | ((x & 0x33u) << 2);
  return ((x & 0xAAu) >> 1) | ((x & 0x55u) << 1);
}

__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x = (x | (x << 4)) & 0x0F0Fu;
  x = (x | (x << 2)) & 0x3333u;
  x = (x | (x << 1)) & 0x5555u;
  return x * 0x3u;
}

__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  x = (x | (x << 3)) & 0x11111111u;
  return x * 0xFu;
}

// ORs ``pat`` (bit q = pixel pos + q) into the five line words.
__device__ __forceinline__ void place_bits(uint32_t* w, uint32_t pat,
                                           int pos) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int sh = pos - 32 * k;
    if (sh >= 0 && sh < 32) {
      w[k] |= pat << sh;
    } else if (sh < 0 && sh > -32) {
      w[k] |= pat >> (-sh);
    }
  }
}

__device__ void pf_words(uint32_t* w, uint32_t pf0, uint32_t pf1,
                         uint32_t pf2, uint32_t ctrl) {
  const uint32_t seq = ((pf0 >> 4) & 0xFu) | (rev8(pf1 & 0xFFu) << 4) |
                       ((pf2 & 0xFFu) << 12);
  const uint32_t rev = (rev8(seq & 0xFFu) << 12) |
                       (rev8((seq >> 8) & 0xFFu) << 4) |
                       (rev8((seq >> 16) & 0xFu) >> 4);
  const uint32_t right = (ctrl & 1u) ? rev : seq;
  const uint32_t l0 = spread4(seq & 0xFFu), l1 = spread4((seq >> 8) & 0xFFu),
                 l2 = spread4((seq >> 16) & 0xFu);
  const uint32_t r0 = spread4(right & 0xFFu),
                 r1 = spread4((right >> 8) & 0xFFu),
                 r2 = spread4((right >> 16) & 0xFu);
  w[0] = l0;
  w[1] = l1;
  w[2] = (l2 & 0xFFFFu) | (r0 << 16);
  w[3] = ((r0 >> 16) & 0xFFFFu) | (r1 << 16);
  w[4] = ((r1 >> 16) & 0xFFFFu) | ((r2 & 0xFFFFu) << 16);
}

__device__ void player_words(uint32_t* w, uint32_t grp, int pos,
                             uint32_t nusiz, uint32_t refp) {
  const uint32_t mode7 = nusiz & 7u;
  const uint32_t base = (refp & 0x08u) ? grp : rev8(grp & 0xFFu);
  const uint32_t pat = mode7 == 5 ? spread2(base & 0xFFu)
                       : mode7 == 7 ? spread4(base & 0xFFu)
                                    : base;
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = 0;
  place_bits(w, pat, pos);
  if (mode7 == 1 || mode7 == 3) place_bits(w, pat, pos + 16);
  if (mode7 == 2 || mode7 == 3 || mode7 == 6) place_bits(w, pat, pos + 32);
  if (mode7 == 4 || mode7 == 6) place_bits(w, pat, pos + 64);
}

__device__ void bar_words(uint32_t* w, bool on, uint32_t size_bits, int pos) {
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = 0;
  if (on) {
    const uint32_t width = 1u << (size_bits & 3u);
    place_bits(w, (1u << width) - 1u, pos);
  }
}

__device__ __forceinline__ uint32_t hit(const uint32_t* u, const uint32_t* v) {
  return ((u[0] & v[0]) | (u[1] & v[1]) | (u[2] & v[2]) | (u[3] & v[3]) |
          (u[4] & v[4])) != 0u;
}

// Line-record columns (tia.R_*).
enum Rec {
  R_PF0, R_PF1, R_PF2, R_COLUPF, R_COLUBK, R_CTRLPF, R_COLUP0, R_COLUP1,
  R_GRP0, R_GRP1, R_POSP0, R_POSP1, R_NUSIZ0, R_NUSIZ1, R_ENAM0, R_ENAM1,
  R_ENABL, R_POSM0, R_POSM1, R_POSBL, R_REFP0, R_REFP1, R_RESMP0, R_RESMP1
};

// [8] collision-latch bits of one line record (machine_kernel._collisions).
__device__ void collisions(const int* rec, uint32_t* out) {
  uint32_t pf[5], bl[5], p0[5], p1[5], m0[5], m1[5];
  pf_words(pf, rec[R_PF0], rec[R_PF1], rec[R_PF2], rec[R_CTRLPF]);
  bar_words(bl, (rec[R_ENABL] & 2) != 0, (rec[R_CTRLPF] >> 4) & 3,
            rec[R_POSBL]);
  player_words(p0, rec[R_GRP0], rec[R_POSP0], rec[R_NUSIZ0], rec[R_REFP0]);
  player_words(p1, rec[R_GRP1], rec[R_POSP1], rec[R_NUSIZ1], rec[R_REFP1]);
  bar_words(m0, (rec[R_ENAM0] & 2) != 0 && (rec[R_RESMP0] & 2) == 0,
            (rec[R_NUSIZ0] >> 4) & 3, rec[R_POSM0]);
  bar_words(m1, (rec[R_ENAM1] & 2) != 0 && (rec[R_RESMP1] & 2) == 0,
            (rec[R_NUSIZ1] >> 4) & 3, rec[R_POSM1]);
  out[0] = (hit(m0, p1) << 7) | (hit(m0, p0) << 6);
  out[1] = (hit(m1, p0) << 7) | (hit(m1, p1) << 6);
  out[2] = (hit(p0, pf) << 7) | (hit(p0, bl) << 6);
  out[3] = (hit(p1, pf) << 7) | (hit(p1, bl) << 6);
  out[4] = (hit(m0, pf) << 7) | (hit(m0, bl) << 6);
  out[5] = (hit(m1, pf) << 7) | (hit(m1, bl) << 6);
  out[6] = hit(bl, pf) << 7;
  out[7] = (hit(p0, p1) << 7) | (hit(m0, m1) << 6);
}

// ---------------------------------------------------------------------------
// One machine
// ---------------------------------------------------------------------------

__device__ __forceinline__ int mod160(int v) {
  v %= 160;
  return v < 0 ? v + 160 : v;
}

struct Machine {
  // Registers.
  uint32_t a, x, y, sp, pc, p, bank, cycles, swcha, inpt4;
  int waddr, scanline, line_cycles, grp0_old, grp1_old, enabl_old, wrapped;
  int pos[5];  // P0 P1 M0 M1 BL
  // This machine's column of the block's shared byte files ([addr][lane]).
  uint8_t* ram;
  uint8_t* tia;
  uint8_t* cx;
  // The cart and its decode table, shared by the block.
  const uint8_t* rom;
  const uint32_t* decode;
  int nbanks;

  __device__ uint8_t& ram_at(uint32_t i) { return ram[i * kThreads]; }
  __device__ uint8_t& tia_at(uint32_t i) { return tia[i * kThreads]; }
  __device__ uint8_t& cx_at(uint32_t i) { return cx[i * kThreads]; }

  __device__ uint32_t rom_base() const {
    return nbanks > 1 ? bank * 4096u : 0u;
  }

  // Full bus read (machine_kernel._read).
  __device__ uint32_t read(uint32_t addr) {
    const uint32_t a = addr & 0x1FFFu;
    if (a >= 0x1000u) return rom[rom_base() + (a & 0xFFFu)];
    if ((a & 0x200u) == 0) {
      if (a & 0x80u) return ram_at(a & 0x7Fu);
      const uint32_t idx = a & 0xFu;  // TIA read map
      if (idx < 8) return cx_at(idx);
      if (idx == 0xC) return inpt4 & 0xFFu;
      if (idx == 0xD) return 0x80u;
      return 0;
    }
    return a == 0x280u ? (swcha & 0xFFu) : 0u;
  }

  // Bus write: RAM, or a TIA register below $40 (recorded in waddr).
  __device__ void write(uint32_t addr, uint32_t value) {
    const uint32_t a = addr & 0x1FFFu;
    if (a < 0x1000u && (a & 0x200u) == 0 && (a & 0x80u)) {
      ram_at(a & 0x7Fu) = static_cast<uint8_t>(value);
    } else if (a < 0x40u) {
      tia_at(a) = static_cast<uint8_t>(value);
      waddr = static_cast<int>(a);
    }
  }

  // Stack push: RAM only ($180-$1FF), nothing below.
  __device__ void push(uint32_t s, uint32_t value) {
    if (s & 0x80u) ram_at(s & 0x7Fu) = static_cast<uint8_t>(value);
  }

  __device__ uint32_t zn(uint32_t flags, uint32_t v) {
    v &= 0xFFu;
    return (flags & ~(F_Z | F_N)) | (v == 0 ? F_Z : 0u) | (v & F_N);
  }

  __device__ void step();
  __device__ void beam(int wrote, uint32_t pre_vsync);
  __device__ void record(int* rec);
};

__device__ void Machine::step() {
  waddr = -1;
  const uint32_t pre_vsync = tia_at(0);
  uint32_t opc, b1, b2;
  // The batched JAX step's fetch rule: inside a 4K window (and not in its
  // last two bytes) read the cart at pc & 0xFFF, else the full bus.
  if (pc >= 0x1000u && (pc & 0xFFFu) < 0xFFDu) {
    const uint8_t* at = rom + rom_base() + (pc & 0xFFFu);
    opc = at[0];
    b1 = at[1];
    b2 = at[2];
  } else {
    opc = read(pc);
    b1 = read(pc + 1);
    b2 = read(pc + 2);
  }
  const uint32_t dec = decode[opc];
  const uint32_t mode = dec & 0xFFu, op = (dec >> 8) & 0xFFu,
                 size = (dec >> 16) & 0xFFu, cyc = dec >> 24;

  const uint32_t abs_a = b1 | (b2 << 8);
  uint32_t addr = 0;
  switch (mode) {
    case ZP: addr = b1; break;
    case ZPX: addr = (b1 + x) & 0xFFu; break;
    case ZPY: addr = (b1 + y) & 0xFFu; break;
    case ABS: case IND: addr = abs_a; break;
    case ABX: addr = (abs_a + x) & 0xFFFFu; break;
    case ABY: addr = (abs_a + y) & 0xFFFFu; break;
    case IZX: {
      const uint32_t ptr = (b1 + x) & 0xFFu;
      addr = read(ptr) | (read((ptr + 1) & 0xFFu) << 8);
      break;
    }
    case IZY:
      addr = ((read(b1) | (read((b1 + 1) & 0xFFu) << 8)) + y) & 0xFFFFu;
      break;
    default: break;
  }
  const bool touches = mode != IMP && mode != ACC && mode != IMM && mode != REL;
  uint32_t mem_v = touches ? read(addr) : 0u;
  if (mode == IND) {  // JMP (ind): the vector's high byte wraps in its page
    const uint32_t am = abs_a & 0x1FFFu;
    const uint32_t wrap = (am & 0xFF00u) | ((am + 1) & 0xFFu);
    addr = read(am) | (read(wrap) << 8);
  }
  const uint32_t v = mode == IMM ? b1 : mode == ACC ? a : mem_v;
  const uint32_t carry = p & F_C;
  const bool decimal = (p & F_D) != 0;
  uint32_t next_pc = (pc + size) & 0xFFFFu;

  switch (op) {
    case O_LDA: a = v; p = zn(p, v); break;
    case O_LDX: x = v; p = zn(p, v); break;
    case O_LDY: y = v; p = zn(p, v); break;
    case O_STA: write(addr, a); break;
    case O_STX: write(addr, x); break;
    case O_STY: write(addr, y); break;
    case O_TAX: x = a; p = zn(p, a); break;
    case O_TAY: y = a; p = zn(p, a); break;
    case O_TXA: a = x; p = zn(p, x); break;
    case O_TYA: a = y; p = zn(p, y); break;
    case O_TSX: x = sp; p = zn(p, sp); break;
    case O_TXS: sp = x; break;
    case O_PHA: push(sp, a); sp = (sp - 1) & 0xFFu; break;
    case O_PHP: push(sp, p | F_B | F_U); sp = (sp - 1) & 0xFFu; break;
    case O_PLA:
      sp = (sp + 1) & 0xFFu;
      a = read(0x100u + sp);
      p = zn(p, a);
      break;
    case O_PLP:
      sp = (sp + 1) & 0xFFu;
      p = (read(0x100u + sp) & ~F_B) | F_U;
      break;
    case O_AND: a &= v; p = zn(p, a); break;
    case O_ORA: a |= v; p = zn(p, a); break;
    case O_EOR: a ^= v; p = zn(p, a); break;
    case O_ADC: {
      const uint32_t sum = a + v + carry;
      const uint32_t rb = sum & 0xFFu;
      uint32_t q = zn(p, rb) & ~(F_C | F_V);
      if (!decimal) {
        q |= (sum > 0xFFu ? F_C : 0u) |
             ((~(a ^ v) & (a ^ sum) & 0x80u) ? F_V : 0u);
        a = rb;
      } else {  // NMOS decimal: Z from the binary sum, N and V mid-fix
        uint32_t lo = (a & 0x0Fu) + (v & 0x0Fu) + carry;
        uint32_t hi = (a & 0xF0u) + (v & 0xF0u);
        if (lo > 0x09u) { hi += 0x10u; lo += 0x06u; }
        const bool vd = (~(a ^ v) & (a ^ hi) & 0x80u) != 0;
        const bool nd = (hi & 0x80u) != 0;
        if (hi > 0x90u) hi += 0x60u;
        q = (q & ~F_N) | (nd ? F_N : 0u) | (hi > 0xF0u ? F_C : 0u) |
            (vd ? F_V : 0u);
        a = ((lo & 0x0Fu) | (hi & 0xF0u)) & 0xFFu;
      }
      p = q;
      break;
    }
    case O_SBC: {
      const uint32_t sv = v ^ 0xFFu;
      const uint32_t sum = a + sv + carry;
      const uint32_t rb = sum & 0xFFu;
      p = (zn(p, rb) & ~(F_C | F_V)) | (sum > 0xFFu ? F_C : 0u) |
          ((~(a ^ sv) & (a ^ sum) & 0x80u) ? F_V : 0u);
      if (decimal) {
        // Signed nibble arithmetic; only the low bits of the results count.
        int lo = static_cast<int>(a & 0x0Fu) - static_cast<int>(v & 0x0Fu) -
                 static_cast<int>(1u - carry);
        const bool lo_b = (lo & 0x10) != 0;
        if (lo_b) lo -= 6;
        int hi = static_cast<int>(a >> 4) - static_cast<int>(v >> 4) -
                 (lo_b ? 1 : 0);
        if (hi & 0x10) hi -= 6;
        a = (static_cast<uint32_t>(lo) & 0x0Fu) |
            ((static_cast<uint32_t>(hi) & 0x0Fu) << 4);
      } else {
        a = rb;
      }
      break;
    }
    case O_CMP: case O_CPX: case O_CPY: {
      const uint32_t src = op == O_CMP ? a : op == O_CPX ? x : y;
      p = (zn(p, src - v) & ~F_C) | (src >= v ? F_C : 0u);
      break;
    }
    case O_INC: case O_DEC: {
      const uint32_t r = (op == O_INC ? mem_v + 1 : mem_v - 1) & 0xFFu;
      write(addr, r);
      p = zn(p, r);
      break;
    }
    case O_INX: x = (x + 1) & 0xFFu; p = zn(p, x); break;
    case O_INY: y = (y + 1) & 0xFFu; p = zn(p, y); break;
    case O_DEX: x = (x - 1) & 0xFFu; p = zn(p, x); break;
    case O_DEY: y = (y - 1) & 0xFFu; p = zn(p, y); break;
    case O_ASL: case O_LSR: case O_ROL: case O_ROR: {
      uint32_t r, cout;
      if (op == O_ASL) { r = (v << 1) & 0xFFu; cout = (v >> 7) & 1u; }
      else if (op == O_LSR) { r = v >> 1; cout = v & 1u; }
      else if (op == O_ROL) { r = ((v << 1) | carry) & 0xFFu; cout = (v >> 7) & 1u; }
      else { r = (v >> 1) | (carry << 7); cout = v & 1u; }
      if (mode == ACC) a = r; else write(addr, r);
      p = (zn(p, r) & ~F_C) | cout;
      break;
    }
    case O_JMP: next_pc = addr; break;
    case O_JSR: {
      const uint32_t ret = (pc + 2) & 0xFFFFu;
      push(sp, ret >> 8);
      push((sp - 1) & 0xFFu, ret & 0xFFu);
      sp = (sp - 2) & 0xFFu;
      next_pc = abs_a;
      break;
    }
    case O_RTS: {
      const uint32_t lo = read(0x100u + ((sp + 1) & 0xFFu));
      const uint32_t hi = read(0x100u + ((sp + 2) & 0xFFu));
      sp = (sp + 2) & 0xFFu;
      next_pc = ((lo | (hi << 8)) + 1) & 0xFFFFu;
      break;
    }
    case O_RTI: {
      const uint32_t f = read(0x100u + ((sp + 1) & 0xFFu));
      const uint32_t lo = read(0x100u + ((sp + 2) & 0xFFu));
      const uint32_t hi = read(0x100u + ((sp + 3) & 0xFFu));
      sp = (sp + 3) & 0xFFu;
      p = (f & ~F_B) | F_U;
      next_pc = lo | (hi << 8);
      break;
    }
    case O_BCC: case O_BCS: case O_BEQ: case O_BMI: case O_BNE: case O_BPL:
    case O_BVC: case O_BVS: {
      uint32_t flag;
      bool want;
      switch (op) {
        case O_BCC: flag = F_C; want = false; break;
        case O_BCS: flag = F_C; want = true; break;
        case O_BEQ: flag = F_Z; want = true; break;
        case O_BNE: flag = F_Z; want = false; break;
        case O_BMI: flag = F_N; want = true; break;
        case O_BPL: flag = F_N; want = false; break;
        case O_BVC: flag = F_V; want = false; break;
        default: flag = F_V; want = true; break;
      }
      if (((p & flag) != 0) == want) {
        // rel = b1 as a signed byte
        next_pc = (next_pc + b1 + (b1 < 0x80u ? 0u : 0xFF00u)) & 0xFFFFu;
      }
      break;
    }
    case O_BIT:
      p = (p & ~(F_Z | F_N | F_V)) | ((a & v) == 0 ? F_Z : 0u) | (v & 0xC0u);
      break;
    case O_CLC: p &= ~F_C; break;
    case O_SEC: p |= F_C; break;
    case O_CLD: p &= ~F_D; break;
    case O_SED: p |= F_D; break;
    case O_CLI: p &= ~F_I; break;
    case O_SEI: p |= F_I; break;
    case O_CLV: p &= ~F_V; break;
    default: break;  // BRK, NOP: pc advances by the size only
  }

  // Bank switching: hotspot on a data/jump access and on the next fetch.
  if (nbanks > 1) {
    const int hot = nbanks == 2 ? 0xFF8 : 0xFF6;
    const uint32_t acc = addr & 0x1FFFu;
    const int off = static_cast<int>(acc & 0xFFFu) - hot;
    if (touches && acc >= 0x1000u && off >= 0 && off < nbanks) {
      bank = static_cast<uint32_t>(off);
    }
    const uint32_t facc = next_pc & 0x1FFFu;
    const int foff = static_cast<int>(facc & 0xFFFu) - hot;
    if (facc >= 0x1000u && foff >= 0 && foff < nbanks) {
      bank = static_cast<uint32_t>(foff);
    }
  }
  pc = next_pc;
  cycles += cyc;
  line_cycles += static_cast<int>(cyc);
  if (waddr >= 0) beam(waddr, pre_vsync);
  // RESMP: while set, the missile tracks its player's center.
  for (int m = 0; m < 2; ++m) {
    if (tia_at(0x28 + m) & 2) {
      const uint32_t mode7 = tia_at(0x04 + m) & 7u;
      const int scale = mode7 == 5 ? 2 : mode7 == 7 ? 4 : 1;
      pos[2 + m] = mod160(pos[m] + 4 * scale);
    }
  }
}

// TIA beam bookkeeping after a write to TIA register ``wrote``
// (machine_kernel.step_batched's tail, tia._instr).
__device__ void Machine::beam(int wrote, uint32_t pre_vsync) {
  if (wrote == 0x1B) grp1_old = tia_at(0x1C);
  if (wrote == 0x1C) {
    grp0_old = tia_at(0x1B);
    enabl_old = tia_at(0x1F);
  }
  if (wrote >= 0x10 && wrote <= 0x14) {
    const int beam_x = min(max(line_cycles * 3 - 68, 0), 159);
    pos[wrote - 0x10] = beam_x;
  }
  if (wrote == 0x2A) {  // HMOVE: signed high nibbles of HMP0..HMBL
    for (int i = 0; i < 5; ++i) {
      const int nib = (tia_at(0x20 + i) >> 4) & 0xF;
      pos[i] = mod160(pos[i] - (nib >= 8 ? nib - 16 : nib));
    }
  }
  if (wrote == 0x2B) {
    for (int i = 0x20; i < 0x25; ++i) tia_at(i) = 0;
  }
  if (wrote == 0x02) line_cycles = kCyclesPerLine;
  if (wrote == 0x2C) {
    for (int i = 0; i < 8; ++i) cx_at(i) = 0;
  }
  if (wrote == 0x00 && (pre_vsync & 2u) && !(tia_at(0) & 2u)) {
    if (scanline > 3) wrapped = 1;
    scanline = 3;
  }
}

__device__ void Machine::record(int* rec) {
  rec[R_PF0] = tia_at(0x0D);
  rec[R_PF1] = tia_at(0x0E);
  rec[R_PF2] = tia_at(0x0F);
  rec[R_COLUPF] = tia_at(0x08);
  rec[R_COLUBK] = tia_at(0x09);
  rec[R_CTRLPF] = tia_at(0x0A);
  rec[R_COLUP0] = tia_at(0x06);
  rec[R_COLUP1] = tia_at(0x07);
  rec[R_GRP0] = (tia_at(0x25) & 1) ? grp0_old : tia_at(0x1B);
  rec[R_GRP1] = (tia_at(0x26) & 1) ? grp1_old : tia_at(0x1C);
  rec[R_POSP0] = pos[0];
  rec[R_POSP1] = pos[1];
  rec[R_NUSIZ0] = tia_at(0x04);
  rec[R_NUSIZ1] = tia_at(0x05);
  rec[R_ENAM0] = tia_at(0x1D);
  rec[R_ENAM1] = tia_at(0x1E);
  rec[R_ENABL] = (tia_at(0x27) & 1) ? enabl_old : tia_at(0x1F);
  rec[R_POSM0] = pos[2];
  rec[R_POSM1] = pos[3];
  rec[R_POSBL] = pos[4];
  rec[R_REFP0] = tia_at(0x0B);
  rec[R_REFP1] = tia_at(0x0C);
  rec[R_RESMP0] = tia_at(0x28);
  rec[R_RESMP1] = tia_at(0x29);
}

__global__ void __launch_bounds__(kThreads)
machine_frame_kernel(const uint8_t* __restrict__ rom_g, int rom_size,
                     const int* __restrict__ decode_g, int* __restrict__ scal,
                     int* __restrict__ ram_g, int* __restrict__ tia_g,
                     int* __restrict__ cx_g, int* __restrict__ lines, int n) {
  extern __shared__ uint32_t smem[];
  uint32_t* decode = smem;                                   // [256]
  uint8_t* rom = reinterpret_cast<uint8_t*>(smem + 256);     // [rom_size]
  uint8_t* files = rom + rom_size;                           // [200][kThreads]
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kThreads + lane;

  for (int k = lane; k < 256; k += kThreads) {
    const int* d = decode_g + 4 * k;  // mode, op, size, cycles
    decode[k] = static_cast<uint32_t>(d[0]) |
                (static_cast<uint32_t>(d[1]) << 8) |
                (static_cast<uint32_t>(d[2]) << 16) |
                (static_cast<uint32_t>(d[3]) << 24);
  }
  const uint4* rom_v = reinterpret_cast<const uint4*>(rom_g);
  uint4* rom_s = reinterpret_cast<uint4*>(rom);
  for (int k = lane; k < rom_size / 16; k += kThreads) rom_s[k] = rom_v[k];

  Machine m;
  m.ram = files + lane;
  m.tia = files + 128 * kThreads + lane;
  m.cx = files + 192 * kThreads + lane;
  m.rom = rom;
  m.decode = decode;
  m.nbanks = rom_size / 4096;
  const bool live = i < n;
  if (live) {
    for (int k = 0; k < 128; ++k) m.ram_at(k) = static_cast<uint8_t>(ram_g[i * 128 + k]);
    for (int k = 0; k < 64; ++k) m.tia_at(k) = static_cast<uint8_t>(tia_g[i * 64 + k]);
    for (int k = 0; k < 8; ++k) m.cx_at(k) = static_cast<uint8_t>(cx_g[i * 8 + k]);
  }
  __syncthreads();
  if (!live) return;

  auto s = [&](int k) -> int& { return scal[k * n + i]; };
  m.a = s(S_A); m.x = s(S_X); m.y = s(S_Y); m.sp = s(S_SP); m.pc = s(S_PC);
  m.p = s(S_P); m.bank = s(S_BANK);
  m.cycles = static_cast<uint32_t>(s(S_CYCLES));
  m.waddr = s(S_WADDR); m.swcha = s(S_SWCHA); m.inpt4 = s(S_INPT4);
  m.line_cycles = s(S_LINE_CYCLES);
  for (int k = 0; k < 5; ++k) m.pos[k] = s(S_POSP0 + k);
  m.grp0_old = s(S_GRP0_OLD); m.grp1_old = s(S_GRP1_OLD);
  m.enabl_old = s(S_ENABL_OLD);
  m.scanline = 0;
  m.wrapped = 0;

  int* my_lines = lines + static_cast<size_t>(i) * kVisible * kNReg;
  for (int slot = 0; slot < kSlots; ++slot) {
    for (int count = 0; m.line_cycles < kCyclesPerLine && count < kBudget;
         ++count) {
      m.step();
    }
    const int vis = m.scanline - kFirstVisible;
    if (vis >= 0 && vis < kVisible) {
      int rec[kNReg];
      m.record(rec);
      uint32_t hits[8];
      collisions(rec, hits);
      for (int k = 0; k < 8; ++k) m.cx_at(k) |= static_cast<uint8_t>(hits[k]);
      int* row = my_lines + vis * kNReg;
      for (int k = 0; k < kNReg; ++k) row[k] = rec[k];
    }
    m.scanline += 1;
    m.line_cycles -= kCyclesPerLine;
    if (m.wrapped || m.scanline >= kSlots) break;
  }

  s(S_A) = m.a; s(S_X) = m.x; s(S_Y) = m.y; s(S_SP) = m.sp; s(S_PC) = m.pc;
  s(S_P) = m.p; s(S_BANK) = m.bank;
  s(S_CYCLES) = static_cast<int>(m.cycles);
  s(S_WADDR) = m.waddr;
  s(S_SCANLINE) = m.scanline; s(S_LINE_CYCLES) = m.line_cycles;
  for (int k = 0; k < 5; ++k) s(S_POSP0 + k) = m.pos[k];
  s(S_GRP0_OLD) = m.grp0_old; s(S_GRP1_OLD) = m.grp1_old;
  s(S_ENABL_OLD) = m.enabl_old;
  s(S_WRAPPED) = m.wrapped;
  for (int k = 0; k < 128; ++k) ram_g[i * 128 + k] = m.ram_at(k);
  for (int k = 0; k < 64; ++k) tia_g[i * 64 + k] = m.tia_at(k);
  for (int k = 0; k < 8; ++k) cx_g[i * 8 + k] = m.cx_at(k);
}

// Test entry: the collision bits of ``n`` line records [n, 24] -> [n, 8].
__global__ void machine_collisions_kernel(const int* __restrict__ rec,
                                          int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t hits[8];
  collisions(rec + i * kNReg, hits);
  for (int k = 0; k < 8; ++k) out[i * 8 + k] = static_cast<int>(hits[k]);
}

size_t shared_bytes(int rom_size) {
  return 256 * sizeof(uint32_t) + rom_size + 200 * kThreads;
}

}  // namespace

extern "C" int machine_frame_launch(const uint8_t* rom, int rom_size,
                                    const int* decode, int* scal, int* ram,
                                    int* tia, int* cx, int* lines, int n,
                                    void* stream) {
  const size_t smem = shared_bytes(rom_size);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        machine_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  machine_frame_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rom, rom_size, decode, scal, ram, tia, cx, lines, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int machine_collisions_launch(const int* rec, int* out, int n,
                                         void* stream) {
  machine_collisions_kernel<<<(n + 127) / 128, 128, 0,
                              static_cast<cudaStream_t>(stream)>>>(rec, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* machine_frame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int machine_frame_num_scalars() { return NS; }
