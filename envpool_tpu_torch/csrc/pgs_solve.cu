// The constraint solver's projected Gauss-Seidel, on Hopper: everything of
// constraint_force after the rows, in one launch.
//
// Replaces no Pallas kernel: the JAX package forms A = J M^-1 J^T with
// XLA and runs the sweeps as a jax.lax.fori_loop over rows inside a
// fori_loop over iterations (envpool_tpu/physics/solver.py::
// constraint_force), which XLA compiles into one loop on the device.  In
// eager PyTorch the sweeps alone would be ~7 launches per row update, and
// the formation writes a dense [N, nr, nr] A for the few active rows.  So
// both run here.  Per env n, with its active rows k (in their original
// order) and the Cholesky factor L of M (M = L L^T):
//
//     y_k    = L^-1 j_k                        (forward substitution)
//     A_kl   = y_k . y_l                       (= j_k M^-1 j_l)
//     b_k    = j_k . qacc_smooth - aref_k
//     diag_k = max(A_kk + R_k, 1e-10)
//     f_k    = max(0, f_k - (sum_l A_kl f_l + b_k + R_k f_k) / diag_k)
//
// the last repeated `iterations` times over the rows from f = 0; then
// qfrc = sum_k j_k f_k.  Inputs J [N, nr, nv], L [N, nv, nv] (as its
// transpose, row-major: cholesky_ex's own column-major layout), ok [N] and
// active [N, nr] (bool bytes), qacc_smooth [N, nv], aref, R [N, nr];
// outputs f [N, nr] (0 on inactive rows) and qfrc [N, nv].  An env whose
// M is not SPD (ok false) gets NaN in qfrc and on its active rows' f, as
// the plain route's NaN solve gives.  max(0, x) keeps a NaN, as
// jnp.maximum does.  Instantiated for float and double.
//
// Dropping inactive rows is exact: their force starts at 0 and the JAX
// update multiplies it by 0 again, so they never enter another row's sum.
//
// Bound: the chain.  Each row update needs the one before it, so an env's
// sweeps are (active rows) x iterations dependent steps; the longest env
// sets the floor, at one dependent FMA plus a max per step (chip_smoke.py
// measures that with fma_max_chase_kernel).  The bytes (J's active rows,
// L's lower triangle, qacc_smooth, aref, R, active in; f, qfrc out) take
// less at Ant's widths.
//
// Design.  Eight lanes per env, four envs per warp, 16 envs per block of
// 128 threads, at most 128 registers a thread: four blocks per SM keep 64
// envs resident, so Ant's 8192 envs run in one wave on 132 SMs.
//  - The lanes gather their env's active rows (ballot + popc, in order)
//    into a workspace.  Row k belongs to lane k % 8, slot k / 8.
//  - Resident path (every env of the warp has at most Rows<T> active
//    rows): the lanes copy the env's L and their rows' j into shared
//    memory, each lane solves for y of its rows (its rows interleaved, so
//    their substitutions overlap), forms A_lk of its rows against every k
//    (independent sums, kept in registers), and writes A + diag(R) over y
//    and L, column by column.  It keeps g_l (the running residual, = b_l
//    at f = 0), f_l and 1 / diag_l of its rows in registers.  A row update
//    is then: row k's lane computes the new f_k from its g_k; one shuffle
//    broadcasts delta = f_k,new - f_k; every lane adds
//    (A_lk + [l=k] R_k) delta to its residuals, with A's column k loaded
//    before delta arrives.  No barrier on the chain, and the loop runs to
//    the warp's most active rows and no further.  That is the same
//    Gauss-Seidel algebra as the JAX loop, which recomputes g_k from f;
//    only rounding differs, and a reciprocal of diag replaces the
//    division.
//  - Device-memory path (some env of the warp has more rows, or the
//    model's L and block do not fit a block's shared memory, as the dog's
//    79 dofs in double): y, g and 1 / diag live in the workspace, and
//    A_lk is formed from y when a row's delta reaches it.  Same algebra,
//    same order.
//  - The four envs of a warp run to the warp's most active rows; an env
//    past its own rows broadcasts delta = 0.
//
// Plain C interface, loaded with ctypes: the wrapper (ops/cuda_pgs.py)
// checks shapes, dtypes, devices and contiguity and allocates the
// workspace before it calls pgs_solve_launch_f32 / _f64.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;                            // lanes per env
constexpr int kEnvsPerWarp = 32 / kGroup;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kEnvsPerBlock = kEnvsPerWarp * kWarps;
constexpr int kBlocksPerSm = 4;
constexpr int kChunk = 16;  // loads a lane keeps in flight while it copies
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can have

// Most active rows an env keeps in registers and shared memory.
template <typename T> struct Rows;
template <> struct Rows<float> { static constexpr int value = 24; };
template <> struct Rows<double> { static constexpr int value = 16; };

// Elements of shared memory an env keeps on the resident path: y of its
// rows and L^T, later A of its block; padded so that the four envs of a
// warp fall on different banks.
template <typename T>
__host__ __device__ constexpr size_t region_elems(int nv) {
  constexpr int C = Rows<T>::value;
  const size_t yl = static_cast<size_t>(C) * nv + static_cast<size_t>(nv) * nv;
  return ((yl > C * C ? yl : C * C) + 31) / 32 * 32 + 8;
}

__device__ __forceinline__ float qnan(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double qnan(double) { return CUDART_NAN; }

template <typename T>
__device__ __forceinline__ T dot(const T* a, const T* b, int n) {
  T s = T(0);
#pragma unroll 4
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// y = L^-1 j: y_i = (j_i - L_i0 y_0 - L_i1 y_1 - ...) / L_ii, summed in
// that order.  Lt is L's transpose, row-major (L_im = Lt[m * nv + i]).
template <typename T>
__device__ void forward_subst(const T* __restrict__ Lt, const T* __restrict__ j, T* y,
                              int nv) {
  for (int i = 0; i < nv; ++i) {
    T acc = j[i];
#pragma unroll 4
    for (int m = 0; m < i; ++m) acc -= Lt[m * nv + i] * y[m];
    y[i] = acc / Lt[i * nv + i];
  }
}

// max(0, x), keeping a NaN.  In float by the integer max of the bits (one
// instruction, not a compare and a select): negative numbers and -0 have
// the sign bit, and the NaN that arithmetic returns is 0x7fffffff.
__device__ __forceinline__ float relu(float x) {
  return __int_as_float(max(__float_as_int(x), 0));
}
__device__ __forceinline__ double relu(double x) { return x < 0.0 ? 0.0 : x; }

template <typename T>
__device__ __forceinline__ T inv_diag(T a_kk, T r) {
  const T d = a_kk + r;
  return T(1) / (d < T(1e-10) ? T(1e-10) : d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    pgs_kernel(const T* __restrict__ J, const T* __restrict__ Lt,
               const unsigned char* __restrict__ ok, const T* __restrict__ qacc,
               const T* __restrict__ aref, const T* __restrict__ R,
               const unsigned char* __restrict__ active, T* __restrict__ f,
               T* __restrict__ qfrc, int* __restrict__ ws_idx, T* __restrict__ ws,
               int n, int nr, int nv, int iterations, bool resident) {
  constexpr int C = Rows<T>::value;
  constexpr int S = C / kGroup;  // rows a lane keeps
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31;
  const int p = lane & (kGroup - 1);
  const int grp = lane / kGroup;
  const int slot = (threadIdx.x >> 5) * kEnvsPerWarp + grp;
  const int env = blockIdx.x * kEnvsPerBlock + slot;
  const bool live = env < n;
  const size_t e = live ? static_cast<size_t>(env) : 0;

  const T* Je = J + e * nr * nv;
  const T* Le = Lt + e * nv * nv;  // L^T: row i is column i of L
  const T* qe = qacc + e * nv;
  const T* ae = aref + e * nr;
  const T* Re = R + e * nr;
  int* idx = ws_idx + e * nr;
  T* fv = ws + e * nr * (nv + 3);  // f of the gathered rows
  T* wg = fv + nr;                 // device-memory path: g, 1 / diag, y
  T* wi = wg + nr;
  T* wy = wi + nr;

  // Gather the active rows in their original order.
  int na = 0;
#pragma unroll 4
  for (int base = 0; base < nr; base += kGroup) {
    const int i = base + p;
    const bool a = live && i < nr && active[e * nr + i] != 0;
    const unsigned m = (__ballot_sync(kFull, a) >> (grp * kGroup)) & 0xffu;
    if (a) idx[na + __popc(m & ((1u << p) - 1u))] = i;
    na += __popc(m);
  }
  const int nw = __reduce_max_sync(kFull, na);  // the warp's most
  __syncwarp();
  // Where the output stage finds f and the row of each gathered row.
  const T* f_src = fv;
  const int* idx_src = idx;

  if (resident && nw <= C) {
    // This env's shared memory: y of its rows (row r at r * nv) and L^T
    // after them; then, once formed, A + diag(R) of the block, column k
    // at k * C.
    T* yv = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(slot) * region_elems<T>(nv);
    bool own[S];
    int row[S];
    T rr[S], ar[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      own[s] = s * kGroup + p < na;
      row[s] = 0;
      rr[s] = ar[s] = T(0);
      if (own[s]) {
        row[s] = idx[s * kGroup + p];
        rr[s] = Re[row[s]];
        ar[s] = ae[row[s]];
      }
    }
    // The rows' j into y's place, b = j . qacc_smooth - aref on the way,
    // and L^T into shared memory: the substitution below is a chain of
    // dependent steps, and each would otherwise wait on L1 or device
    // memory.  (In chunks whose loads all start before the first is used:
    // a warp runs its instructions in order, so a loop of load-then-store
    // waits on each load.)
    T g[S];
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] = T(0);
    for (int i0 = 0; own[0] && i0 < nv; i0 += kChunk) {
      T jv[S][kChunk], qv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        qv[u] = i0 + u < nv ? qe[i0 + u] : T(0);
#pragma unroll
        for (int s = 0; s < S; ++s)
          jv[s][u] = own[s] && i0 + u < nv ? Je[static_cast<size_t>(row[s]) * nv + i0 + u] : T(0);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (own[s] && i0 + u < nv) {
            yv[(s * kGroup + p) * nv + i0 + u] = jv[s][u];
            g[s] += jv[s][u] * qv[u];
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] -= ar[s];
    // All of L^T, the zeros below its diagonal too: the substitution reads
    // only L's lower triangle, but masking the rest out of the copy costs
    // the warp more instructions than the bytes it saves.
    T* Ls = yv + C * nv;
    for (int o0 = 0; na > 0 && o0 < nv * nv; o0 += kGroup * kChunk) {
      T v[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int o = o0 + u * kGroup + p;
        v[u] = o < nv * nv ? Le[o] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int o = o0 + u * kGroup + p;
        if (o < nv * nv) Ls[o] = v[u];
      }
    }
    __syncwarp();
    // y = L^-1 j as forward_subst computes it, the lane's rows
    // interleaved (own[0] is false only for a lane with no rows).
    for (int i = 0; own[0] && i < nv; ++i) {
      T acc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = yv[(s * kGroup + p) * nv + i];
#pragma unroll 4
      for (int m = 0; m < i; ++m) {
        const T lim = Ls[m * nv + i];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] -= lim * yv[(s * kGroup + p) * nv + m];
      }
      // The divisions of all the lane's rows at once (a slot without a row
      // divides 1, not what its shared memory holds), stored where owned.
      const T lii = Ls[i * nv + i];
      T yi[S];
#pragma unroll
      for (int s = 0; s < S; ++s) yi[s] = (own[s] ? acc[s] : T(1)) / lii;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (own[s]) yv[(s * kGroup + p) * nv + i] = yi[s];
    }
    __syncwarp();
    // A_lk = y_l . y_k for the lane's rows l against every k, summed over
    // i in order (rows past na hold garbage and are masked below).
    T a[S][C], d[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      d[s] = T(0);
#pragma unroll
      for (int k = 0; k < C; ++k) a[s][k] = T(0);
    }
    for (int i = 0; own[0] && i < nv; ++i) {
      T yo[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        yo[s] = own[s] ? yv[(s * kGroup + p) * nv + i] : T(0);
        d[s] += yo[s] * yo[s];
      }
#pragma unroll
      for (int kb = 0; kb < S; ++kb) {
        if (kb * kGroup < nw) {
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const T yk = yv[(kb * kGroup + q) * nv + i];
#pragma unroll
            for (int s = 0; s < S; ++s) a[s][kb * kGroup + q] += yo[s] * yk;
          }
        }
      }
    }
    T fk[S], inv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      fk[s] = T(0);
      inv[s] = own[s] ? inv_diag(d[s], rr[s]) : T(0);
    }
    __syncwarp();  // every lane has read y and L; A takes their place
    T* As = yv;
#pragma unroll
    for (int kb = 0; kb < S; ++kb) {
      if (kb * kGroup < nw) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int k = kb * kGroup + q;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int r = s * kGroup + p;
            const T v = k == r ? a[s][k] + rr[s] : a[s][k];
            As[k * C + r] = own[s] && k < na ? v : T(0);
          }
        }
      }
    }
    __syncwarp();
    for (int it = 0; it < iterations; ++it) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int kend = min(kGroup, nw - s * kGroup);
#pragma unroll 1  // unrolled, the loop runs slower (more code, same chain)
        for (int q = 0; q < kend; ++q) {
          const T* col = As + (s * kGroup + q) * C + p;
          T ak[S];
#pragma unroll
          for (int t = 0; t < S; ++t) ak[t] = col[t * kGroup];
          // Row k = s * 8 + q is lane q's: only its delta is broadcast.
          const T x = relu(fk[s] - g[s] * inv[s]);
          const T delta = __shfl_sync(kFull, x - fk[s], q, kGroup);
          fk[s] = p == q ? x : fk[s];
#pragma unroll
          for (int t = 0; t < S; ++t) g[t] += ak[t] * delta;
        }
      }
    }
    // f and the rows of the block, for the output stage, over A.
    __syncwarp();
    T* fo = As;
    int* io = reinterpret_cast<int*>(As + C);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (own[s]) {
        fo[s * kGroup + p] = fk[s];
        io[s * kGroup + p] = row[s];
      }
    }
    f_src = fo;
    idx_src = io;
  } else {
    for (int r = p; r < na; r += kGroup)
      forward_subst(Le, Je + static_cast<size_t>(idx[r]) * nv,
                    wy + static_cast<size_t>(r) * nv, nv);
    __syncwarp();
    for (int r = p; r < na; r += kGroup) {
      const T* yr = wy + static_cast<size_t>(r) * nv;
      const int row = idx[r];
      wi[r] = inv_diag(dot(yr, yr, nv), Re[row]);
      wg[r] = dot(Je + static_cast<size_t>(row) * nv, qe, nv) - ae[row];
      fv[r] = T(0);
    }
    for (int it = 0; it < iterations; ++it) {
      for (int k = 0; k < nw; ++k) {
        const int q = k & (kGroup - 1);
        T delta = T(0), rk = T(0);
        if (p == q && k < na) {
          const T fo = fv[k];
          const T x = relu(fo - wg[k] * wi[k]);
          delta = x - fo;
          fv[k] = x;
          rk = Re[idx[k]];
        }
        delta = __shfl_sync(kFull, delta, q, kGroup);
        if (k < na) {
          const T* yk = wy + static_cast<size_t>(k) * nv;
          for (int r = p; r < na; r += kGroup) {
            const T v = dot(wy + static_cast<size_t>(r) * nv, yk, nv);
            wg[r] += (r == k ? v + rk : v) * delta;
          }
        }
      }
    }
  }
  __syncwarp();

  // f on every row (0 where inactive), then qfrc = J^T f.
  const bool good = live && ok[e] != 0;
  if (live)
    for (int i = p; i < nr; i += kGroup) f[e * nr + i] = T(0);
  __syncwarp();
  if (live) {
    for (int k = p; k < na; k += kGroup)
      f[e * nr + idx_src[k]] = good ? f_src[k] : qnan(T(0));
    for (int c = p; c < nv; c += kGroup) {
      T s = T(0);
#pragma unroll 8
      for (int k = 0; k < na; ++k) s += Je[static_cast<size_t>(idx_src[k]) * nv + c] * f_src[k];
      qfrc[e * nv + c] = good ? s : qnan(T(0));
    }
  }
}

// Test entries, one warp each: `iters` dependent steps; out[0] = SM clocks
// over the chain, out[1] = where it ended.  reduce_chase_kernel: a
// warp-wide sum (the step of the earlier one-warp-per-env design);
// fma_max_chase_kernel: one FMA and the max of a row update, the least a
// step needs.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void reduce_chase_kernel(long long* __restrict__ out, int iters) {
  T v = T(threadIdx.x) * T(1e-3);
  for (int k = 0; k < 8; ++k) v = warp_sum(v) * T(0.03125);  // warm
  const long long t0 = clock64();
  for (int k = 0; k < iters; ++k) v = warp_sum(v) * T(0.03125);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(v * T(1e6));
  }
}

template <typename T>
__global__ void fma_max_chase_kernel(long long* __restrict__ out, int iters, T a, T c) {
  T v = T(threadIdx.x) * T(1e-3);
  for (int k = 0; k < 8; ++k) v = relu(v * a + c);  // warm
  const long long t0 = clock64();
  for (int k = 0; k < iters; ++k) v = relu(v * a + c);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(v * T(1e6));
  }
}

// Shared memory a block needs for the resident path, or 0 where it would
// not fit (a model of many dofs: every env then takes the device-memory
// path).
template <typename T>
size_t smem_bytes(int nv) {
  const size_t bytes = kEnvsPerBlock * region_elems<T>(nv) * sizeof(T);
  return bytes <= kMaxSmem ? bytes : 0;
}

template <typename T>
int allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        pgs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  return 0;
}

template <typename T>
int launch(const T* J, const T* Lt, const unsigned char* ok, const T* qacc, const T* aref,
           const T* R, const unsigned char* active, T* f, T* qfrc, int* ws_idx, T* ws, int n,
           int nr, int nv, int iterations, void* stream) {
  const size_t smem = smem_bytes<T>(nv);
  if (const int err = allow_smem<T>(smem)) return err;
  const int blocks = (n + kEnvsPerBlock - 1) / kEnvsPerBlock;
  pgs_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      J, Lt, ok, qacc, aref, R, active, f, qfrc, ws_idx, ws, n, nr, nv, iterations, smem > 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int nv, int* out) {
  const size_t smem = smem_bytes<T>(nv);
  if (const int err = allow_smem<T>(smem)) return err;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], pgs_kernel<T>, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  out[2] = kEnvsPerBlock;
  out[3] = static_cast<int>(smem);
  out[4] = Rows<T>::value;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int pgs_solve_launch_f32(const float* J, const float* Lt, const unsigned char* ok,
                                    const float* qacc, const float* aref, const float* R,
                                    const unsigned char* active, float* f, float* qfrc,
                                    int* ws_idx, float* ws, int n, int nr, int nv,
                                    int iterations, void* stream) {
  return launch<float>(J, Lt, ok, qacc, aref, R, active, f, qfrc, ws_idx, ws, n, nr, nv,
                       iterations, stream);
}

extern "C" int pgs_solve_launch_f64(const double* J, const double* Lt, const unsigned char* ok,
                                    const double* qacc, const double* aref, const double* R,
                                    const unsigned char* active, double* f, double* qfrc,
                                    int* ws_idx, double* ws, int n, int nr, int nv,
                                    int iterations, void* stream) {
  return launch<double>(J, Lt, ok, qacc, aref, R, active, f, qfrc, ws_idx, ws, n, nr, nv,
                        iterations, stream);
}

// out[0] blocks per SM, out[1] SMs, out[2] envs per block, out[3] shared
// memory bytes per block, for a model of nv dofs; out[4] the most active
// rows an env keeps resident.
extern "C" int pgs_solve_occupancy(int nv, int dbl, int* out) {
  return dbl ? occupancy<double>(nv, out) : occupancy<float>(nv, out);
}

// kind: 0 a warp-wide sum, 1 an FMA and a max.
extern "C" int pgs_chase_launch(long long* out, int iters, int dbl, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0 && dbl) {
    reduce_chase_kernel<double><<<1, 32, 0, s>>>(out, iters);
  } else if (kind == 0) {
    reduce_chase_kernel<float><<<1, 32, 0, s>>>(out, iters);
  } else if (dbl) {
    fma_max_chase_kernel<double><<<1, 32, 0, s>>>(out, iters, -0.5, 1.0);
  } else {
    fma_max_chase_kernel<float><<<1, 32, 0, s>>>(out, iters, -0.5f, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pgs_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
