// Projected Gauss-Seidel for the constraint solver, on Hopper.
//
// Replaces no Pallas kernel: the JAX package runs these sweeps as a
// jax.lax.fori_loop over rows inside a fori_loop over iterations
// (envpool_tpu/physics/solver.py::constraint_force), which XLA compiles
// into one loop on the device.  In eager PyTorch the same loop is ~7
// launches per row update: at Ant's 108 rows x 40 sweeps, ~30,000 launches
// per constraint solve, 20 solves per env step.  So the sweeps run here,
// all of them in one launch.  Per env n, with rows i in order:
//
//     g_i = sum_j A[n,i,j] f_j + b[n,i] + R[n,i] f_i
//     f_i = max(0, f_i - g_i / diag[n,i])      (active rows; others stay 0)
//
// repeated `iterations` times from f = 0, for A [N, nr, nr], b, R, diag
// [N, nr] and active [N, nr] (bool bytes); f [N, nr] is written.
//
// Bound: the chain.  Each row update needs the dot product of the row
// before it, so an env's sweeps are (active rows) x iterations dependent
// steps, each at least one warp-wide reduction; the longest env's chain
// sets the floor (chip_smoke.py measures one dependent reduction with
// reduce_chase_kernel).  The bytes (the active block of A, read once) take
// far less at the main path's widths.
//
// Design: one warp per env (block of 32 threads).  The warp gathers the
// env's active rows in their original order (ballot + popc), then keeps
// b, R, diag and f of those rows in shared memory, and the active block of
// A too when it has at most `cap` rows; past that (the dog's 881 rows), A
// is read from device memory in the same loop, through the gathered
// indices.  Skipping inactive rows is exact: their force starts at 0 and
// the JAX update multiplies it by 0 again, so they never change another
// row's sum.  Only the order of each dot product's terms differs from the
// JAX loop's.  The lanes split a row's dot product; an xor butterfly
// gives every lane the same sum, so each lane computes the same new f_i
// and lane 0 stores it.  max(0, x) keeps a NaN, as jnp.maximum does.
// Instantiated for float and double.
//
// Plain C interface, loaded with ctypes: the wrapper (ops/cuda_pgs.py)
// checks shapes, dtypes, devices and contiguity before it calls
// pgs_solve_launch_f32 / _f64.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32)
    pgs_kernel(const T* __restrict__ A, const T* __restrict__ b,
               const T* __restrict__ R, const T* __restrict__ diag,
               const unsigned char* __restrict__ active, T* __restrict__ f,
               int nr, int iterations, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fv = reinterpret_cast<T*>(smem_raw);  // [nr] each, gathered order
  T* bv = fv + nr;
  T* rv = bv + nr;
  T* dv = rv + nr;
  T* As = dv + nr;  // [cap, cap]
  int* idx = reinterpret_cast<int*>(As + static_cast<size_t>(cap) * cap);  // [nr]

  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * nr;
  const T* Ae = A + row0 * nr;

  int na = 0;
  for (int base = 0; base < nr; base += 32) {
    const int i = base + lane;
    const bool a = i < nr && active[row0 + i] != 0;
    const unsigned m = __ballot_sync(kFull, a);
    if (a) idx[na + __popc(m & ((1u << lane) - 1u))] = i;
    na += __popc(m);
  }
  __syncwarp();
  for (int k = lane; k < na; k += 32) {
    const size_t i = row0 + idx[k];
    bv[k] = b[i];
    rv[k] = R[i];
    dv[k] = diag[i];
    fv[k] = T(0);
  }
  const bool cached = na <= cap;
  if (cached) {
    for (int e = lane; e < na * na; e += 32) {
      const int r = e / na;
      As[e] = Ae[static_cast<size_t>(idx[r]) * nr + idx[e - r * na]];
    }
  }
  __syncwarp();

  for (int it = 0; it < iterations; ++it) {
    for (int k = 0; k < na; ++k) {
      T part = T(0);
      if (cached) {
        const T* row = As + k * na;
        for (int j = lane; j < na; j += 32) part += row[j] * fv[j];
      } else {
        const T* row = Ae + static_cast<size_t>(idx[k]) * nr;
        for (int j = lane; j < na; j += 32) part += row[idx[j]] * fv[j];
      }
      const T fk = fv[k];
      const T g = warp_sum(part) + bv[k] + rv[k] * fk;
      const T x = fk - g / dv[k];
      const T fnew = x < T(0) ? T(0) : x;
      __syncwarp();
      if (lane == 0) fv[k] = fnew;
      __syncwarp();
    }
  }

  T* fe = f + row0;
  for (int i = lane; i < nr; i += 32) fe[i] = T(0);
  __syncwarp();
  for (int k = lane; k < na; k += 32) fe[idx[k]] = fv[k];
}

// Test entry: one warp runs `iters` dependent warp-wide sums (each input
// is the last sum); out[0] = SM clocks over the chain, out[1] = the end.
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
int launch(const T* A, const T* b, const T* R, const T* diag,
           const unsigned char* active, T* f, int n, int nr, int iterations,
           int cap, void* stream) {
  const size_t smem = static_cast<size_t>(nr) * (4 * sizeof(T) + sizeof(int)) +
                      static_cast<size_t>(cap) * cap * sizeof(T);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        pgs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  pgs_kernel<T><<<n, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      A, b, R, diag, active, f, nr, iterations, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pgs_solve_launch_f32(const float* A, const float* b,
                                    const float* R, const float* diag,
                                    const unsigned char* active, float* f,
                                    int n, int nr, int iterations, int cap,
                                    void* stream) {
  return launch<float>(A, b, R, diag, active, f, n, nr, iterations, cap, stream);
}

extern "C" int pgs_solve_launch_f64(const double* A, const double* b,
                                    const double* R, const double* diag,
                                    const unsigned char* active, double* f,
                                    int n, int nr, int iterations, int cap,
                                    void* stream) {
  return launch<double>(A, b, R, diag, active, f, n, nr, iterations, cap, stream);
}

extern "C" int pgs_reduce_chase_launch(long long* out, int iters, int dbl,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl) {
    reduce_chase_kernel<double><<<1, 32, 0, s>>>(out, iters);
  } else {
    reduce_chase_kernel<float><<<1, 32, 0, s>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pgs_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
