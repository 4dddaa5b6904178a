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
// WHAT BOUNDS IT
//
// A machine's frame is one serial chain of emulated instructions (~4,000
// on the pong cart), and each needs at least one shared-memory load whose
// address depends on the instruction before: the fetch at the new PC.  The
// frame ends when the slowest machine does, so the floor is (most
// instructions on one machine) x (one dependent shared-memory load, ~29 SM
// clocks), which chip_smoke.py measures with smem_chase_kernel.  The bytes
// the frame moves (~21 MB at 1024 machines) take a tenth of that.  K2
// spends ~500 SM clocks per emulated instruction instead: the handler's
// own dependent instructions and the compare-and-branch tree that picks
// it (nvcc emits no indirect jump for the switch; tools/k2_probe.py
// --phases splits the clocks).  At 1024 machines the card holds only ~2
// warps per SM, so nothing hides that latency.  A 6502 has no matrix
// products: the tensor cores have no part here.
//
// DESIGN
//
// - Geometry: kMpw machines share a warp, kLanes = 32 / kMpw lanes each,
//   in blocks of 8 machines.  The default, 4 per warp, was the fastest of
//   1, 4, 8 and 32 at 1024-4096 machines (tools/k2_probe.py): one machine
//   per warp never diverges, but its 32 lanes issue one chain, and at 4096
//   machines the card runs out of issue slots; more per warp diverge where
//   their programs do.  The lanes of a machine
//   share the parallel work: state load and store (coalesced, block-wide),
//   the record row, the five collision words, HMOVE's five motions, the
//   clears of HMCLR and CXCLR.  The 6502 chain runs uniform in the group.
// - Fetch: one 64-bit word per cart offset, the JAX meta row (b0, b1, b2,
//   mode, op, size, cycles, 0), built once per cart by the wrapper
//   (machine_kernel.build_tables).  The whole table (32/64/128 KB for
//   4K/F8/F6) goes into shared memory by cp.async.bulk while the block
//   stages its machines.  An instruction costs one load; the bus path is
//   kept only where the JAX rule asks (PC below $1000 or in a window's last
//   two bytes), and a bus read of the cart takes a word's low byte.
// - Dispatch: one handler per opcode, its mode, op, size and cycles
//   resolved at compile time.
// - Registers: CPU registers, the beam, the object positions (indexed by
//   constants only), RESMP and the NUSIZ scale of both players (refreshed
//   on writes to NUSIZ0/1 and RESMP0/1).  No stack, no spills.
// - Shared memory besides the table: each machine's RAM, TIA read map,
//   SWCHA and register file as bytes, machine-minor, and the scalars.
//
// Arithmetic is unsigned where it may wrap (cycles), as JAX lets int32
// wrap; shifts never take negative amounts.
//
// Plain C interface, loaded with ctypes: the wrapper checks shapes, dtypes,
// devices, alignment and contiguity before it calls machine_frame_launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 262;
constexpr int kBudget = 40;
constexpr int kFirstVisible = 40;
constexpr int kVisible = 192;
constexpr int kNReg = 24;
constexpr int kCyclesPerLine = 76;
constexpr int kBankWords = 4096;  // fetch words per 4K bank

// A machine's bytes: RAM; the TIA read map ($0-$F: collision latches,
// zeros, INPT4, $80, zeros); SWCHA; the TIA register file.
constexpr int kRam = 0, kCx = 128, kZero = 136, kInpt4 = 140, kC80 = 141,
              kSwcha = 144, kTia = 148, kFiles = 212;

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

// Each opcode's decode, mode | op << 8 | size << 16 | cycles << 24: the
// port's cpu6502.CPU_TABLES, which the wrapper checks this copy against
// when it loads the kernel.
constexpr uint32_t kDecode[256] = {
    0x07012E00, 0x0602110A, 0x02013700, 0x02013700, 0x02013700, 0x03021103, 0x05021E03, 0x02013700,
    0x03010D00, 0x02021102, 0x02011E01, 0x02013700, 0x02013700, 0x04031106, 0x06031E06, 0x02013700,
    0x02022A0C, 0x0502110B, 0x02013700, 0x02013700, 0x02013700, 0x04021104, 0x06021E04, 0x02013700,
    0x02013000, 0x04031108, 0x02013700, 0x02013700, 0x02013700, 0x04031107, 0x07031E07, 0x02013700,
    0x06032306, 0x0602100A, 0x02013700, 0x02013700, 0x03022D03, 0x03021003, 0x05022003, 0x02013700,
    0x04010F00, 0x02021002, 0x02012001, 0x02013700, 0x04032D06, 0x04031006, 0x06032006, 0x02013700,
    0x0202280C, 0x0502100B, 0x02013700, 0x02013700, 0x02013700, 0x04021004, 0x06022004, 0x02013700,
    0x02013400, 0x04031008, 0x02013700, 0x02013700, 0x02013700, 0x04031007, 0x07032007, 0x02013700,
    0x06012F00, 0x0602120A, 0x02013700, 0x02013700, 0x02013700, 0x03021203, 0x05021F03, 0x02013700,
    0x03010C00, 0x02021202, 0x02011F01, 0x02013700, 0x03032206, 0x04031206, 0x06031F06, 0x02013700,
    0x02022B0C, 0x0502120B, 0x02013700, 0x02013700, 0x02013700, 0x04021204, 0x06021F04, 0x02013700,
    0x02013200, 0x04031208, 0x02013700, 0x02013700, 0x02013700, 0x04031207, 0x07031F07, 0x02013700,
    0x06012400, 0x0602130A, 0x02013700, 0x02013700, 0x02013700, 0x03021303, 0x05022103, 0x02013700,
    0x04010E00, 0x02021302, 0x02012101, 0x02013700, 0x05032209, 0x04031306, 0x06032106, 0x02013700,
    0x02022C0C, 0x0502130B, 0x02013700, 0x02013700, 0x02013700, 0x04021304, 0x06022104, 0x02013700,
    0x02013600, 0x04031308, 0x02013700, 0x02013700, 0x02013700, 0x04031307, 0x07032107, 0x02013700,
    0x02013700, 0x0602030A, 0x02013700, 0x02013700, 0x03020503, 0x03020303, 0x03020403, 0x02013700,
    0x02011D00, 0x02013700, 0x02010800, 0x02013700, 0x04030506, 0x04030306, 0x04030406, 0x02013700,
    0x0202250C, 0x0602030B, 0x02013700, 0x02013700, 0x04020504, 0x04020304, 0x04020405, 0x02013700,
    0x02010900, 0x05030308, 0x02010B00, 0x02013700, 0x02013700, 0x05030307, 0x02013700, 0x02013700,
    0x02020202, 0x0602000A, 0x02020102, 0x02013700, 0x03020203, 0x03020003, 0x03020103, 0x02013700,
    0x02010700, 0x02020002, 0x02010600, 0x02013700, 0x04030206, 0x04030006, 0x04030106, 0x02013700,
    0x0202260C, 0x0502000B, 0x02013700, 0x02013700, 0x04020204, 0x04020004, 0x04020105, 0x02013700,
    0x02013300, 0x04030008, 0x02010A00, 0x02013700, 0x04030207, 0x04030007, 0x04030108, 0x02013700,
    0x02021702, 0x0602150A, 0x02013700, 0x02013700, 0x03021703, 0x03021503, 0x05021B03, 0x02013700,
    0x02011A00, 0x02021502, 0x02011C00, 0x02013700, 0x04031706, 0x04031506, 0x06031B06, 0x02013700,
    0x0202290C, 0x0502150B, 0x02013700, 0x02013700, 0x02013700, 0x04021504, 0x06021B04, 0x02013700,
    0x02013100, 0x04031508, 0x02013700, 0x02013700, 0x02013700, 0x04031507, 0x07031B07, 0x02013700,
    0x02021602, 0x0602140A, 0x02013700, 0x02013700, 0x03021603, 0x03021403, 0x05021803, 0x02013700,
    0x02011900, 0x02021402, 0x02013700, 0x02013700, 0x04031606, 0x04031406, 0x06031806, 0x02013700,
    0x0202270C, 0x0502140B, 0x02013700, 0x02013700, 0x02013700, 0x04021404, 0x06021804, 0x02013700,
    0x02013500, 0x04031408, 0x02013700, 0x02013700, 0x02013700, 0x04031407, 0x07031807, 0x02013700,
};

// TIA writes whose bookkeeping is off the common path: VSYNC, NUSIZ0/1,
// RESMP0/1, HMOVE, HMCLR, CXCLR.
constexpr uint64_t kBeamRare = (1ull << 0x00) | (1ull << 0x04) |
                               (1ull << 0x05) | (1ull << 0x28) |
                               (1ull << 0x29) | (1ull << 0x2A) |
                               (1ull << 0x2B) | (1ull << 0x2C);

// Line-record columns (tia.R_*).
enum Rec {
  R_PF0, R_PF1, R_PF2, R_COLUPF, R_COLUBK, R_CTRLPF, R_COLUP0, R_COLUP1,
  R_GRP0, R_GRP1, R_POSP0, R_POSP1, R_NUSIZ0, R_NUSIZ1, R_ENAM0, R_ENAM1,
  R_ENABL, R_POSM0, R_POSM1, R_POSBL, R_REFP0, R_REFP1, R_RESMP0, R_RESMP1
};

// The TIA register each record column copies (0: a position column), as
// three words of eight byte-sized entries so that a lane can look its
// column up without a memory load.
constexpr uint8_t kRecReg[kNReg] = {
    0x0D, 0x0E, 0x0F, 0x08, 0x09, 0x0A, 0x06, 0x07,
    0x1B, 0x1C, 0x00, 0x00, 0x04, 0x05, 0x1D, 0x1E,
    0x1F, 0x00, 0x00, 0x00, 0x0B, 0x0C, 0x28, 0x29};

constexpr uint64_t pack8(int first) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) {
    v |= static_cast<uint64_t>(kRecReg[first + i]) << (8 * i);
  }
  return v;
}
constexpr uint64_t kRecReg0 = pack8(0), kRecReg1 = pack8(8),
                   kRecReg2 = pack8(16);

// Block geometry for kMpw machines per warp (kLanes lanes per machine).
template <int kMpw>
struct Geometry {
  static constexpr int kLanes = 32 / kMpw;
  static constexpr int kWarps = kMpw >= 8 ? 1 : 8 / kMpw;
  static constexpr int kMachines = kWarps * kMpw;  // per block
  static constexpr int kThreads = 32 * kWarps;
};

// ---------------------------------------------------------------------------
// Collision words (machine_kernel._rev8 ... _collisions), one 32-pixel
// word w (pixels 32w .. 32w + 31) at a time.
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

// Word w of ``pat`` placed at pixel ``pos`` (bit q = pixel pos + q).
__device__ __forceinline__ uint32_t place_word(uint32_t pat, int pos, int w) {
  const int sh = pos - 32 * w;
  if (sh >= 0 && sh < 32) return pat << sh;
  if (sh < 0 && sh > -32) return pat >> (-sh);
  return 0u;
}

__device__ __forceinline__ uint32_t pf_word(uint32_t pf0, uint32_t pf1,
                                            uint32_t pf2, uint32_t ctrl,
                                            int w) {
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
  return w == 0   ? l0
         : w == 1 ? l1
         : w == 2 ? (l2 & 0xFFFFu) | (r0 << 16)
         : w == 3 ? ((r0 >> 16) & 0xFFFFu) | (r1 << 16)
                  : ((r1 >> 16) & 0xFFFFu) | ((r2 & 0xFFFFu) << 16);
}

__device__ __forceinline__ uint32_t player_word(uint32_t grp, int pos,
                                                uint32_t nusiz, uint32_t refp,
                                                int w) {
  const uint32_t mode7 = nusiz & 7u;
  const uint32_t base = (refp & 0x08u) ? grp : rev8(grp & 0xFFu);
  const uint32_t pat = mode7 == 5 ? spread2(base & 0xFFu)
                       : mode7 == 7 ? spread4(base & 0xFFu)
                                    : base;
  uint32_t out = place_word(pat, pos, w);
  if (mode7 == 1 || mode7 == 3) out |= place_word(pat, pos + 16, w);
  if (mode7 == 2 || mode7 == 3 || mode7 == 6) out |= place_word(pat, pos + 32, w);
  if (mode7 == 4 || mode7 == 6) out |= place_word(pat, pos + 64, w);
  return out;
}

__device__ __forceinline__ uint32_t bar_word(bool on, uint32_t size_bits,
                                             int pos, int w) {
  if (!on) return 0u;
  const uint32_t width = 1u << (size_bits & 3u);
  return place_word((1u << width) - 1u, pos, w);
}

// What the collision test reads of one line record.
struct Line {
  uint32_t pf0, pf1, pf2, ctrlpf, grp0, grp1, nusiz0, nusiz1, enam0, enam1,
      enabl, refp0, refp1, resmp0, resmp1;
  int posp0, posp1, posm0, posm1, posbl;
};

// How many of the six objects draw on the line: an upper bound, as a
// player with a non-zero pattern counts wherever it is placed.
__device__ __forceinline__ int drawn(const Line& r) {
  const bool pf = (((r.pf0 >> 4) & 0xFu) | (r.pf1 & 0xFFu) | (r.pf2 & 0xFFu)) != 0;
  const bool m0 = (r.enam0 & 2u) != 0 && (r.resmp0 & 2u) == 0;
  const bool m1 = (r.enam1 & 2u) != 0 && (r.resmp1 & 2u) == 0;
  return pf + (r.grp0 != 0) + (r.grp1 != 0) + m0 + m1 + ((r.enabl & 2u) != 0);
}

// Overlap bits of word w: latch k's bit 7 at bit 2k and bit 6 at 2k + 1,
// in the TIA read map's order: CXM0P(M0·P1, M0·P0) CXM1P(M1·P0, M1·P1)
// CXP0FB(P0·PF, P0·BL) CXP1FB(P1·PF, P1·BL) CXM0FB(M0·PF, M0·BL)
// CXM1FB(M1·PF, M1·BL) CXBLPF(BL·PF) CXPPMM(P0·P1, M0·M1).
__device__ __forceinline__ uint32_t pair_bits(const Line& r, int w) {
  const uint32_t pf = pf_word(r.pf0, r.pf1, r.pf2, r.ctrlpf, w);
  const uint32_t bl = bar_word((r.enabl & 2u) != 0, (r.ctrlpf >> 4) & 3u,
                               r.posbl, w);
  const uint32_t p0 = player_word(r.grp0, r.posp0, r.nusiz0, r.refp0, w);
  const uint32_t p1 = player_word(r.grp1, r.posp1, r.nusiz1, r.refp1, w);
  const uint32_t m0 = bar_word((r.enam0 & 2u) != 0 && (r.resmp0 & 2u) == 0,
                               (r.nusiz0 >> 4) & 3u, r.posm0, w);
  const uint32_t m1 = bar_word((r.enam1 & 2u) != 0 && (r.resmp1 & 2u) == 0,
                               (r.nusiz1 >> 4) & 3u, r.posm1, w);
  auto hit = [](uint32_t u, uint32_t v) { return (u & v) != 0u ? 1u : 0u; };
  return (hit(m0, p1) << 0) | (hit(m0, p0) << 1) | (hit(m1, p0) << 2) |
         (hit(m1, p1) << 3) | (hit(p0, pf) << 4) | (hit(p0, bl) << 5) |
         (hit(p1, pf) << 6) | (hit(p1, bl) << 7) | (hit(m0, pf) << 8) |
         (hit(m0, bl) << 9) | (hit(m1, pf) << 10) | (hit(m1, bl) << 11) |
         (hit(bl, pf) << 12) | (hit(p0, p1) << 14) | (hit(m0, m1) << 15);
}

// Latch k's bits of the OR of every word's pair bits.
__device__ __forceinline__ uint32_t latch(uint32_t bits, int k) {
  return (((bits >> (2 * k)) & 1u) << 7) | (((bits >> (2 * k + 1)) & 1u) << 6);
}

// ---------------------------------------------------------------------------
// One machine, run by the kLanes lanes of its group
// ---------------------------------------------------------------------------

__device__ __forceinline__ int mod160(int v) {
  v %= 160;
  return v < 0 ? v + 160 : v;
}

template <int kMpw, bool kBanked>
struct Machine {
  using G = Geometry<kMpw>;

  // Registers.
  uint32_t a, x, y, sp, pc, p, bank, cycles;
  int waddr, scanline, line_cycles, grp0_old, grp1_old, enabl_old, wrapped;
  int pos[5];      // P0 P1 M0 M1 BL; indexed by constants only
  int center[2];   // RESMP0/1: missile = player + this while set, else -1
  bool resmp;      // either RESMP set
  uint32_t vsync_before;  // VSYNC before this instruction wrote it
  uint32_t instructions;
  // Byte i of this machine's bytes is files[i * kMachines].
  uint8_t* files;
  const uint2* table;      // the cart's fetch words, in shared memory
  int nbanks;
  int sub;                 // lane within the group
  unsigned mask;           // the group's lanes

  __device__ __forceinline__ uint8_t& file(uint32_t i) {
    return files[i * G::kMachines];
  }

  __device__ __forceinline__ uint32_t rom_base() const {
    if constexpr (kBanked) {
      return bank * kBankWords;
    } else {
      return 0;
    }
  }

  // Full bus read (machine_kernel._read), without a branch: the cart byte
  // (a fetch word's low byte), or RAM, the TIA read map or SWCHA.
  __device__ __forceinline__ uint32_t read(uint32_t addr) {
    const uint32_t a13 = addr & 0x1FFFu;
    uint32_t slot = (a13 & 0x80u) ? kRam + (a13 & 0x7Fu) : kCx + (a13 & 0xFu);
    if (a13 & 0x200u) slot = a13 == 0x280u ? kSwcha : kZero;
    const uint8_t* cart =
        reinterpret_cast<const uint8_t*>(table + rom_base() + (a13 & 0xFFFu));
    return *(a13 >= 0x1000u ? cart : &file(slot));
  }

  // Bus read below $100 (zero page; also the stack page, $1xx): RAM or
  // the TIA read map.
  __device__ __forceinline__ uint32_t read_zp(uint32_t addr) {
    return file((addr & 0x80u) ? kRam + (addr & 0x7Fu) : kCx + (addr & 0xFu));
  }

  // A write to TIA register ``reg`` and its beam bookkeeping.
  __device__ __forceinline__ void tia_write(uint32_t reg, uint32_t value) {
    if (reg == 0) vsync_before = file(kTia);
    file(kTia + reg) = static_cast<uint8_t>(value);
    waddr = static_cast<int>(reg);
    beam(static_cast<int>(reg));
    center_missiles();
  }

  // Bus write: RAM, or a TIA register below $40 (recorded in waddr).
  __device__ __forceinline__ void write(uint32_t addr, uint32_t value) {
    const uint32_t a13 = addr & 0x1FFFu;
    if (a13 < 0x1000u && (a13 & 0x200u) == 0 && (a13 & 0x80u)) {
      file(kRam + (a13 & 0x7Fu)) = static_cast<uint8_t>(value);
    } else if (a13 < 0x40u) {
      tia_write(a13, value);
    }
  }

  __device__ __forceinline__ void write_zp(uint32_t addr, uint32_t value) {
    if (addr & 0x80u) {
      file(kRam + (addr & 0x7Fu)) = static_cast<uint8_t>(value);
    } else if (addr < 0x40u) {
      tia_write(addr, value);
    }
  }

  // Stack push: RAM only ($180-$1FF), nothing below.
  __device__ __forceinline__ void push(uint32_t s, uint32_t value) {
    if (s & 0x80u) file(kRam + (s & 0x7Fu)) = static_cast<uint8_t>(value);
  }

  __device__ __forceinline__ static uint32_t zn(uint32_t flags, uint32_t v) {
    v &= 0xFFu;
    return (flags & ~(F_Z | F_N)) | (v == 0 ? F_Z : 0u) | (v & F_N);
  }

  // The group's lanes clear ``count`` bytes from ``base`` together.
  __device__ __forceinline__ void clear(uint32_t base, int count) {
    for (int i = sub; i < count; i += G::kLanes) file(base + i) = 0;
    __syncwarp(mask);
  }

  __device__ __forceinline__ void refresh_centers() {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t mode7 = file(kTia + 0x04 + m) & 7u;
      const int scale = mode7 == 5 ? 2 : mode7 == 7 ? 4 : 1;
      center[m] = (file(kTia + 0x28 + m) & 2u) ? 4 * scale : -1;
    }
    resmp = center[0] >= 0 || center[1] >= 0;
  }

  // RESMP: while set, the missile tracks its player's center.  Only TIA
  // writes move what this reads, so it runs after each of them, and at
  // the end of each line for the frame's first instructions.
  __device__ __forceinline__ void center_missiles() {
    if (__builtin_expect(resmp, 0)) {
      if (center[0] >= 0) pos[2] = mod160(pos[0] + center[0]);
      if (center[1] >= 0) pos[3] = mod160(pos[1] + center[1]);
    }
  }

  __device__ __forceinline__ static int motion(uint32_t hm) {
    const int nib = static_cast<int>((hm >> 4) & 0xFu);
    return nib >= 8 ? nib - 16 : nib;
  }

  // HMOVE: every object moves by the signed high nibble of HMP0..HMBL.
  __device__ __forceinline__ void hmove() {
    if constexpr (G::kLanes >= 5) {
      const int mine = sub < 5 ? motion(file(kTia + 0x20 + sub)) : 0;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        pos[i] = mod160(pos[i] - __shfl_sync(mask, mine, i, G::kLanes));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        pos[i] = mod160(pos[i] - motion(file(kTia + 0x20 + i)));
      }
    }
  }

  // TIA beam bookkeeping after a write to TIA register ``w``
  // (machine_kernel.step_batched's tail, tia._instr): the common registers
  // without a branch, the rest behind one.
  __device__ __forceinline__ void beam(int w) {
    if (w == 0x02) line_cycles = kCyclesPerLine;
    if (w == 0x1B) grp1_old = file(kTia + 0x1C);
    if (w == 0x1C) {
      grp0_old = file(kTia + 0x1B);
      enabl_old = file(kTia + 0x1F);
    }
    const int beam_x = min(max(line_cycles * 3 - 68, 0), 159);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (w == 0x10 + k) pos[k] = beam_x;
    }
    if (__builtin_expect((kBeamRare >> w) & 1u, 0)) {
      switch (w) {
        case 0x00:
          if ((vsync_before & 2u) && !(file(kTia) & 2u)) {
            if (scanline > 3) wrapped = 1;
            scanline = 3;
          }
          break;
        case 0x2A: hmove(); break;
        case 0x2B: clear(kTia + 0x20, 5); break;
        case 0x2C: clear(kCx, 8); break;
        default: refresh_centers(); break;  // NUSIZ0/1, RESMP0/1
      }
    }
  }

  // One instruction of opcode kOpc, everything its decode fixes resolved
  // at compile time (machine_kernel.step_batched for one lane).
  template <uint32_t kOpc>
  __device__ __forceinline__ void exec(uint32_t b1, uint32_t b2) {
    constexpr uint32_t kD = kDecode[kOpc];
    constexpr uint32_t kMode = kD & 0xFFu, kOp = (kD >> 8) & 0xFFu,
                       kSize = (kD >> 16) & 0xFFu, kCyc = kD >> 24;
    constexpr bool kZeroPage = kMode == ZP || kMode == ZPX || kMode == ZPY;
    constexpr bool kTouches = kZeroPage || kMode == ABS || kMode == ABX ||
                              kMode == ABY || kMode == IND || kMode == IZX ||
                              kMode == IZY;
    constexpr bool kReads =
        kOp == O_LDA || kOp == O_LDX || kOp == O_LDY || kOp == O_AND ||
        kOp == O_ORA || kOp == O_EOR || kOp == O_ADC || kOp == O_SBC ||
        kOp == O_CMP || kOp == O_CPX || kOp == O_CPY || kOp == O_BIT ||
        kOp == O_INC || kOp == O_DEC || kOp == O_ASL || kOp == O_LSR ||
        kOp == O_ROL || kOp == O_ROR;
    uint32_t next_pc = (pc + kSize) & 0xFFFFu;
    cycles += kCyc;
    line_cycles += static_cast<int>(kCyc);

    const uint32_t abs_a = b1 | (b2 << 8);
    uint32_t addr = 0;
    if constexpr (kMode == ZP) {
      addr = b1;
    } else if constexpr (kMode == ZPX) {
      addr = (b1 + x) & 0xFFu;
    } else if constexpr (kMode == ZPY) {
      addr = (b1 + y) & 0xFFu;
    } else if constexpr (kMode == ABS || kMode == IND) {
      addr = abs_a;
    } else if constexpr (kMode == ABX) {
      addr = (abs_a + x) & 0xFFFFu;
    } else if constexpr (kMode == ABY) {
      addr = (abs_a + y) & 0xFFFFu;
    } else if constexpr (kMode == IZX) {
      const uint32_t ptr = (b1 + x) & 0xFFu;
      addr = read_zp(ptr) | (read_zp((ptr + 1) & 0xFFu) << 8);
    } else if constexpr (kMode == IZY) {
      addr = ((read_zp(b1) | (read_zp((b1 + 1) & 0xFFu) << 8)) + y) & 0xFFFFu;
    }
    uint32_t v = 0;
    if constexpr (kMode == IMM) {
      v = b1;
    } else if constexpr (kMode == ACC) {
      v = a;
    } else if constexpr (kReads && kZeroPage) {
      v = read_zp(addr);
    } else if constexpr (kReads && kTouches) {
      v = read(addr);
    }
    if constexpr (kMode == IND) {  // JMP (ind): the vector's high byte wraps in its page
      const uint32_t am = abs_a & 0x1FFFu;
      const uint32_t wrap = (am & 0xFF00u) | ((am + 1) & 0xFFu);
      addr = read(am) | (read(wrap) << 8);
    }
    auto store = [&](uint32_t value) {
      if constexpr (kZeroPage) {
        write_zp(addr, value);
      } else {
        write(addr, value);
      }
    };
    const uint32_t carry = p & F_C;

    if constexpr (kOp == O_LDA) {
      a = v; p = zn(p, v);
    } else if constexpr (kOp == O_LDX) {
      x = v; p = zn(p, v);
    } else if constexpr (kOp == O_LDY) {
      y = v; p = zn(p, v);
    } else if constexpr (kOp == O_STA) {
      store(a);
    } else if constexpr (kOp == O_STX) {
      store(x);
    } else if constexpr (kOp == O_STY) {
      store(y);
    } else if constexpr (kOp == O_TAX) {
      x = a; p = zn(p, a);
    } else if constexpr (kOp == O_TAY) {
      y = a; p = zn(p, a);
    } else if constexpr (kOp == O_TXA) {
      a = x; p = zn(p, x);
    } else if constexpr (kOp == O_TYA) {
      a = y; p = zn(p, y);
    } else if constexpr (kOp == O_TSX) {
      x = sp; p = zn(p, sp);
    } else if constexpr (kOp == O_TXS) {
      sp = x;
    } else if constexpr (kOp == O_PHA) {
      push(sp, a); sp = (sp - 1) & 0xFFu;
    } else if constexpr (kOp == O_PHP) {
      push(sp, p | F_B | F_U); sp = (sp - 1) & 0xFFu;
    } else if constexpr (kOp == O_PLA) {
      sp = (sp + 1) & 0xFFu;
      a = read_zp(sp);  // $100 + sp
      p = zn(p, a);
    } else if constexpr (kOp == O_PLP) {
      sp = (sp + 1) & 0xFFu;
      p = (read_zp(sp) & ~F_B) | F_U;
    } else if constexpr (kOp == O_AND) {
      a &= v; p = zn(p, a);
    } else if constexpr (kOp == O_ORA) {
      a |= v; p = zn(p, a);
    } else if constexpr (kOp == O_EOR) {
      a ^= v; p = zn(p, a);
    } else if constexpr (kOp == O_ADC) {
      const uint32_t sum = a + v + carry;
      const uint32_t rb = sum & 0xFFu;
      uint32_t q = zn(p, rb) & ~(F_C | F_V);
      if (__builtin_expect(!(p & F_D), 1)) {
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
    } else if constexpr (kOp == O_SBC) {
      const uint32_t sv = v ^ 0xFFu;
      const uint32_t sum = a + sv + carry;
      const uint32_t rb = sum & 0xFFu;
      p = (zn(p, rb) & ~(F_C | F_V)) | (sum > 0xFFu ? F_C : 0u) |
          ((~(a ^ sv) & (a ^ sum) & 0x80u) ? F_V : 0u);
      if (__builtin_expect(!(p & F_D), 1)) {
        a = rb;
      } else {
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
      }
    } else if constexpr (kOp == O_CMP || kOp == O_CPX || kOp == O_CPY) {
      const uint32_t src = kOp == O_CMP ? a : kOp == O_CPX ? x : y;
      p = (zn(p, src - v) & ~F_C) | (src >= v ? F_C : 0u);
    } else if constexpr (kOp == O_INC || kOp == O_DEC) {
      const uint32_t r = (kOp == O_INC ? v + 1 : v - 1) & 0xFFu;
      store(r);
      p = zn(p, r);
    } else if constexpr (kOp == O_INX) {
      x = (x + 1) & 0xFFu; p = zn(p, x);
    } else if constexpr (kOp == O_INY) {
      y = (y + 1) & 0xFFu; p = zn(p, y);
    } else if constexpr (kOp == O_DEX) {
      x = (x - 1) & 0xFFu; p = zn(p, x);
    } else if constexpr (kOp == O_DEY) {
      y = (y - 1) & 0xFFu; p = zn(p, y);
    } else if constexpr (kOp == O_ASL || kOp == O_LSR || kOp == O_ROL ||
                         kOp == O_ROR) {
      uint32_t r, cout;
      if constexpr (kOp == O_ASL) { r = (v << 1) & 0xFFu; cout = (v >> 7) & 1u; }
      else if constexpr (kOp == O_LSR) { r = v >> 1; cout = v & 1u; }
      else if constexpr (kOp == O_ROL) { r = ((v << 1) | carry) & 0xFFu; cout = (v >> 7) & 1u; }
      else { r = (v >> 1) | (carry << 7); cout = v & 1u; }
      if constexpr (kMode == ACC) {
        a = r;
      } else {
        store(r);
      }
      p = (zn(p, r) & ~F_C) | cout;
    } else if constexpr (kOp == O_JMP) {
      next_pc = addr;
    } else if constexpr (kOp == O_JSR) {
      const uint32_t ret = (pc + 2) & 0xFFFFu;
      push(sp, ret >> 8);
      push((sp - 1) & 0xFFu, ret & 0xFFu);
      sp = (sp - 2) & 0xFFu;
      next_pc = abs_a;
    } else if constexpr (kOp == O_RTS) {
      const uint32_t lo = read_zp((sp + 1) & 0xFFu);
      const uint32_t hi = read_zp((sp + 2) & 0xFFu);
      sp = (sp + 2) & 0xFFu;
      next_pc = ((lo | (hi << 8)) + 1) & 0xFFFFu;
    } else if constexpr (kOp == O_RTI) {
      const uint32_t f = read_zp((sp + 1) & 0xFFu);
      const uint32_t lo = read_zp((sp + 2) & 0xFFu);
      const uint32_t hi = read_zp((sp + 3) & 0xFFu);
      sp = (sp + 3) & 0xFFu;
      p = (f & ~F_B) | F_U;
      next_pc = lo | (hi << 8);
    } else if constexpr (kOp >= O_BCC && kOp <= O_BVS) {
      constexpr uint32_t kFlag = kOp == O_BCC || kOp == O_BCS ? F_C
                                 : kOp == O_BEQ || kOp == O_BNE ? F_Z
                                 : kOp == O_BMI || kOp == O_BPL ? F_N
                                                                : F_V;
      constexpr bool kWant = kOp == O_BCS || kOp == O_BEQ || kOp == O_BMI ||
                             kOp == O_BVS;
      if (((p & kFlag) != 0) == kWant) {
        // rel = b1 as a signed byte
        next_pc = (next_pc + b1 + (b1 < 0x80u ? 0u : 0xFF00u)) & 0xFFFFu;
      }
    } else if constexpr (kOp == O_BIT) {
      p = (p & ~(F_Z | F_N | F_V)) | ((a & v) == 0 ? F_Z : 0u) | (v & 0xC0u);
    } else if constexpr (kOp == O_CLC) {
      p &= ~F_C;
    } else if constexpr (kOp == O_SEC) {
      p |= F_C;
    } else if constexpr (kOp == O_CLD) {
      p &= ~F_D;
    } else if constexpr (kOp == O_SED) {
      p |= F_D;
    } else if constexpr (kOp == O_CLI) {
      p &= ~F_I;
    } else if constexpr (kOp == O_SEI) {
      p |= F_I;
    } else if constexpr (kOp == O_CLV) {
      p &= ~F_V;
    }
    // BRK, NOP: pc advances by the size only.

    // Bank switching: hotspot on a data/jump access and on the next fetch.
    if constexpr (kBanked) {
      const int hot = nbanks == 2 ? 0xFF8 : 0xFF6;
      if constexpr (kTouches) {
        const uint32_t acc = addr & 0x1FFFu;
        const int off = static_cast<int>(acc & 0xFFFu) - hot;
        if (acc >= 0x1000u && off >= 0 && off < nbanks) {
          bank = static_cast<uint32_t>(off);
        }
      }
      const uint32_t facc = next_pc & 0x1FFFu;
      const int foff = static_cast<int>(facc & 0xFFFu) - hot;
      if (facc >= 0x1000u && foff >= 0 && foff < nbanks) {
        bank = static_cast<uint32_t>(foff);
      }
    }
    pc = next_pc;
  }

  __device__ __forceinline__ void step() {
    ++instructions;
    waddr = -1;
    // The batched JAX step's fetch rule: inside a 4K window (and not in
    // its last two bytes) the fetch word at pc & 0xFFF of the bank, else
    // three bus reads.
    uint32_t w = table[rom_base() + (pc & 0xFFFu)].x;
    if (__builtin_expect(pc < 0x1000u || (pc & 0xFFFu) >= 0xFFDu, 0)) {
      w = read(pc) | (read(pc + 1) << 8) | (read(pc + 2) << 16);
    }
    const uint32_t b1 = (w >> 8) & 0xFFu, b2 = (w >> 16) & 0xFFu;
#define K2_OP(n) \
  case n: exec<n>(b1, b2); break;
#define K2_OP4(n) K2_OP(n) K2_OP(n + 1) K2_OP(n + 2) K2_OP(n + 3)
#define K2_OP16(n) K2_OP4(n) K2_OP4(n + 4) K2_OP4(n + 8) K2_OP4(n + 12)
    switch (w & 0xFFu) {
      K2_OP16(0x00) K2_OP16(0x10) K2_OP16(0x20) K2_OP16(0x30)
      K2_OP16(0x40) K2_OP16(0x50) K2_OP16(0x60) K2_OP16(0x70)
      K2_OP16(0x80) K2_OP16(0x90) K2_OP16(0xA0) K2_OP16(0xB0)
      K2_OP16(0xC0) K2_OP16(0xD0) K2_OP16(0xE0) K2_OP16(0xF0)
    }
#undef K2_OP16
#undef K2_OP4
#undef K2_OP
  }

  // Record column k of the closing line (VDEL resolved).
  __device__ __forceinline__ int column(int k) {
    const uint64_t regs = k < 8 ? kRecReg0 : k < 16 ? kRecReg1 : kRecReg2;
    int v = file(kTia + ((regs >> (8 * (k & 7))) & 0xFFu));
    const int vdel = k == R_GRP0 ? 0x25 : k == R_GRP1 ? 0x26 : 0x27;
    const int old = k == R_GRP0 ? grp0_old : k == R_GRP1 ? grp1_old : enabl_old;
    if ((k == R_GRP0 || k == R_GRP1 || k == R_ENABL) && (file(kTia + vdel) & 1)) {
      v = old;
    }
    return k == R_POSP0   ? pos[0]
           : k == R_POSP1 ? pos[1]
           : k == R_POSM0 ? pos[2]
           : k == R_POSM1 ? pos[3]
           : k == R_POSBL ? pos[4]
                          : v;
  }

  __device__ __forceinline__ Line line() {
    Line r;
    r.pf0 = file(kTia + 0x0D);
    r.pf1 = file(kTia + 0x0E);
    r.pf2 = file(kTia + 0x0F);
    r.ctrlpf = file(kTia + 0x0A);
    r.grp0 = (file(kTia + 0x25) & 1) ? grp0_old : file(kTia + 0x1B);
    r.grp1 = (file(kTia + 0x26) & 1) ? grp1_old : file(kTia + 0x1C);
    r.nusiz0 = file(kTia + 0x04);
    r.nusiz1 = file(kTia + 0x05);
    r.enam0 = file(kTia + 0x1D);
    r.enam1 = file(kTia + 0x1E);
    r.enabl = (file(kTia + 0x27) & 1) ? enabl_old : file(kTia + 0x1F);
    r.refp0 = file(kTia + 0x0B);
    r.refp1 = file(kTia + 0x0C);
    r.resmp0 = file(kTia + 0x28);
    r.resmp1 = file(kTia + 0x29);
    r.posp0 = pos[0];
    r.posp1 = pos[1];
    r.posm0 = pos[2];
    r.posm1 = pos[3];
    r.posbl = pos[4];
    return r;
  }

  // A visible line closes: its record row and collision latches.  With
  // fewer than two objects drawn no pair can overlap, and the test is
  // skipped.
  __device__ __forceinline__ void close_visible(int* row) {
    const Line r = line();
    uint32_t bits = 0;
    if (drawn(r) >= 2) {
      for (int w = sub; w < 5; w += G::kLanes) bits |= pair_bits(r, w);
      bits = __reduce_or_sync(mask, bits);
    }
    for (int k = sub; k < kNReg; k += G::kLanes) row[k] = column(k);
    if (bits != 0) {
      for (int k = sub; k < 8; k += G::kLanes) file(kCx + k) |= latch(bits, k);
    }
    __syncwarp(mask);
  }

  __device__ __forceinline__ void run(int* lines) {
    scanline = 0;
    wrapped = 0;
    for (int slot = 0; slot < kSlots; ++slot) {
      for (int count = 0; line_cycles < kCyclesPerLine && count < kBudget;
           ++count) {
        step();
      }
      if (instructions > 0) center_missiles();
      const int vis = scanline - kFirstVisible;
      if (vis >= 0 && vis < kVisible) close_visible(lines + vis * kNReg);
      scanline += 1;
      line_cycles -= kCyclesPerLine;
      if (wrapped || scanline >= kSlots) break;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kMpw, bool kBanked>
__global__ void __launch_bounds__(Geometry<kMpw>::kThreads)
machine_frame_kernel(const uint2* __restrict__ fetch_g, int nbanks,
                     int* __restrict__ scal, int* __restrict__ ram_g,
                     int* __restrict__ tia_g, int* __restrict__ cx_g,
                     int* __restrict__ lines, int* __restrict__ counts, int n) {
  using G = Geometry<kMpw>;
  constexpr int M = G::kMachines;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t table_ready;
  const int table_bytes = nbanks * kBankWords * 8;
  uint8_t* files = smem + table_bytes;                      // [kFiles][M]
  int* stage = reinterpret_cast<int*>(files + kFiles * M);  // [NS][M]
  const int tid = threadIdx.x;
  const int first = blockIdx.x * M;
  const int here = min(M, n - first);

  // Start the fetch table on its way, one bulk copy per 4K bank.
  const uint32_t bar = smem_u32(&table_ready);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(table_bytes) : "memory");
    for (int b = 0; b < nbanks; ++b) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(smem + b * kBankWords * 8)),
          "l"(fetch_g + b * kBankWords), "r"(kBankWords * 8), "r"(bar)
          : "memory");
    }
  }
  // Meanwhile: this block's machines, coalesced.
  for (int i = tid; i < here * 128; i += G::kThreads) {
    files[(kRam + i % 128) * M + i / 128] =
        static_cast<uint8_t>(ram_g[first * 128 + i]);
  }
  for (int i = tid; i < here * 64; i += G::kThreads) {
    files[(kTia + i % 64) * M + i / 64] =
        static_cast<uint8_t>(tia_g[first * 64 + i]);
  }
  for (int i = tid; i < here * 8; i += G::kThreads) {
    files[(kCx + i % 8) * M + i / 8] = static_cast<uint8_t>(cx_g[first * 8 + i]);
  }
  for (int i = tid; i < NS * here; i += G::kThreads) {
    const int k = i / here, m = i % here;
    stage[k * M + m] = scal[k * n + first + m];
  }
  __syncthreads();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar) : "memory");
  }

  const int lane = tid & 31;
  const int m = (tid >> 5) * kMpw + lane / G::kLanes;
  if (m < here) {
    Machine<kMpw, kBanked> mc;
    mc.sub = lane % G::kLanes;
    mc.mask = G::kLanes == 32
                  ? 0xFFFFFFFFu
                  : ((1u << G::kLanes) - 1u) << (lane - mc.sub);
    mc.files = files + m;
    mc.table = reinterpret_cast<const uint2*>(smem);
    mc.nbanks = nbanks;
    auto s = [&](int k) -> int& { return stage[k * M + m]; };
    mc.a = s(S_A); mc.x = s(S_X); mc.y = s(S_Y); mc.sp = s(S_SP);
    mc.pc = s(S_PC); mc.p = s(S_P); mc.bank = s(S_BANK);
    mc.cycles = static_cast<uint32_t>(s(S_CYCLES));
    mc.waddr = s(S_WADDR);
    mc.line_cycles = s(S_LINE_CYCLES);
#pragma unroll
    for (int k = 0; k < 5; ++k) mc.pos[k] = s(S_POSP0 + k);
    mc.grp0_old = s(S_GRP0_OLD); mc.grp1_old = s(S_GRP1_OLD);
    mc.enabl_old = s(S_ENABL_OLD);
    mc.vsync_before = 0;
    mc.instructions = 0;
    mc.refresh_centers();
    if (mc.sub == 0) {  // the rest of the TIA read map, and SWCHA
      for (int k = kZero; k < kTia; ++k) mc.file(k) = 0;
      mc.file(kInpt4) = static_cast<uint8_t>(s(S_INPT4));
      mc.file(kC80) = 0x80;
      mc.file(kSwcha) = static_cast<uint8_t>(s(S_SWCHA));
    }
    __syncwarp(mc.mask);  // every lane has read the stage before lane 0 writes it

    mc.run(lines + static_cast<size_t>(first + m) * kVisible * kNReg);

    if (mc.sub == 0) {
      s(S_A) = mc.a; s(S_X) = mc.x; s(S_Y) = mc.y; s(S_SP) = mc.sp;
      s(S_PC) = mc.pc; s(S_P) = mc.p; s(S_BANK) = mc.bank;
      s(S_CYCLES) = static_cast<int>(mc.cycles);
      s(S_WADDR) = mc.waddr;
      s(S_SCANLINE) = mc.scanline; s(S_LINE_CYCLES) = mc.line_cycles;
#pragma unroll
      for (int k = 0; k < 5; ++k) s(S_POSP0 + k) = mc.pos[k];
      s(S_GRP0_OLD) = mc.grp0_old; s(S_GRP1_OLD) = mc.grp1_old;
      s(S_ENABL_OLD) = mc.enabl_old;
      s(S_WRAPPED) = mc.wrapped;
      if (counts != nullptr) counts[first + m] = static_cast<int>(mc.instructions);
    }
  }
  __syncthreads();
  for (int i = tid; i < NS * here; i += G::kThreads) {
    const int k = i / here, mm = i % here;
    scal[k * n + first + mm] = stage[k * M + mm];
  }
  for (int i = tid; i < here * 128; i += G::kThreads) {
    ram_g[first * 128 + i] = files[(kRam + i % 128) * M + i / 128];
  }
  for (int i = tid; i < here * 64; i += G::kThreads) {
    tia_g[first * 64 + i] = files[(kTia + i % 64) * M + i / 64];
  }
  for (int i = tid; i < here * 8; i += G::kThreads) {
    cx_g[first * 8 + i] = files[(kCx + i % 8) * M + i / 8];
  }
}

// Test entry: the collision bits of ``n`` line records [n, 24] -> [n, 8].
__global__ void machine_collisions_kernel(const int* __restrict__ rec,
                                          int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* c = rec + i * kNReg;
  Line r;
  r.pf0 = c[R_PF0]; r.pf1 = c[R_PF1]; r.pf2 = c[R_PF2];
  r.ctrlpf = c[R_CTRLPF]; r.grp0 = c[R_GRP0]; r.grp1 = c[R_GRP1];
  r.nusiz0 = c[R_NUSIZ0]; r.nusiz1 = c[R_NUSIZ1];
  r.enam0 = c[R_ENAM0]; r.enam1 = c[R_ENAM1]; r.enabl = c[R_ENABL];
  r.refp0 = c[R_REFP0]; r.refp1 = c[R_REFP1];
  r.resmp0 = c[R_RESMP0]; r.resmp1 = c[R_RESMP1];
  r.posp0 = c[R_POSP0]; r.posp1 = c[R_POSP1]; r.posm0 = c[R_POSM0];
  r.posm1 = c[R_POSM1]; r.posbl = c[R_POSBL];
  uint32_t bits = 0;
  if (drawn(r) >= 2) {
    for (int w = 0; w < 5; ++w) bits |= pair_bits(r, w);
  }
  for (int k = 0; k < 8; ++k) out[i * 8 + k] = static_cast<int>(latch(bits, k));
}

// Test entry: one thread chases a pointer ring through shared memory;
// out[0] = SM clocks over ``iters`` dependent loads, out[1] = the end.
__global__ void smem_chase_kernel(long long* __restrict__ out, int iters) {
  __shared__ uint32_t ring[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) ring[i] = (i + 97) & 1023u;
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t j = 0;
  for (int k = 0; k < 64; ++k) j = ring[j];  // warm
  const long long t0 = clock64();
  for (int k = 0; k < iters; k += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) j = ring[j];
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = j;
}

template <int kMpw, bool kBanked>
int launch(const uint2* fetch, int nbanks, int* scal, int* ram, int* tia,
           int* cx, int* lines, int* counts, int n, cudaStream_t stream) {
  using G = Geometry<kMpw>;
  const size_t smem = static_cast<size_t>(nbanks) * kBankWords * 8 +
                      static_cast<size_t>(kFiles + NS * 4) * G::kMachines;
  auto kernel = machine_frame_kernel<kMpw, kBanked>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const int blocks = (n + G::kMachines - 1) / G::kMachines;
  kernel<<<blocks, G::kThreads, smem, stream>>>(fetch, nbanks, scal, ram, tia,
                                                cx, lines, counts, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// machines_per_warp: 4, or with K2_ALL_GEOMETRIES defined also 1, 8, 32.
extern "C" int machine_frame_launch(const void* fetch, int nbanks, int* scal,
                                    int* ram, int* tia, int* cx, int* lines,
                                    int* counts, int n, int machines_per_warp,
                                    void* stream) {
  const uint2* f = static_cast<const uint2*>(fetch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_LAUNCH(MPW)                                                      \
  if (machines_per_warp == MPW) {                                           \
    return nbanks > 1                                                       \
               ? launch<MPW, true>(f, nbanks, scal, ram, tia, cx, lines,    \
                                   counts, n, s)                            \
               : launch<MPW, false>(f, nbanks, scal, ram, tia, cx, lines,   \
                                    counts, n, s);                          \
  }
  K2_LAUNCH(4)
#ifdef K2_ALL_GEOMETRIES
  K2_LAUNCH(1)
  K2_LAUNCH(8)
  K2_LAUNCH(32)
#endif
#undef K2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int machine_collisions_launch(const int* rec, int* out, int n,
                                         void* stream) {
  machine_collisions_kernel<<<(n + 127) / 128, 128, 0,
                              static_cast<cudaStream_t>(stream)>>>(rec, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int machine_smem_chase_launch(long long* out, int iters,
                                         void* stream) {
  smem_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* machine_frame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int machine_frame_num_scalars() { return NS; }

// The kernel's copy of the decode table, for the wrapper to check.
extern "C" void machine_frame_decode(uint32_t* out) {
  for (int i = 0; i < 256; ++i) out[i] = kDecode[i];
}
