// K1 on Hopper: fused max-pool of two frames + INTER_AREA resize -> uint8.
//
// Replaces the Pallas TPU kernel envpool_tpu/ops/pallas_image.py::_kernel
// (driven by fused_pool_resize).  Computes, per row n of a batch:
//
//     out[n] = u8(clip(rint(Wh @ max(f[n,0], f[n,1]) @ Ww), 0, 255))
//
// for frames f [N, 2, H, W] float32 and out [N, h, w] uint8.
//
// Bound: bytes.  Every input float is read once and every output byte
// written once, N * (2*H*W*4 + h*w) bytes; the arithmetic is ~9 FMAs per
// output pixel.  The TPU kernel did two MXU matmuls per frame; here the
// area weights are banded (an output row reads at most ceil(H/h)+1 source
// rows, an output column at most ceil(W/w)+1 source columns), so each
// thread computes one output pixel from a small window instead.
//
// Design: one block per (row n, tile of TH output rows).  The block loads
// the source rows its tile needs from both frames, takes the max once, and
// keeps the pooled rows in shared memory; each source element is read
// from device memory once per block (rows on a tile border are read by
// both neighbouring tiles).  Each thread then sums rows first, then
// columns - the order of Wh @ pooled @ Ww - and rounds half to even with
// __float2int_rn, as jnp.round / torch.round do.
//
// Plain C interface, loaded with ctypes: the wrapper checks shapes, dtypes,
// devices and contiguity before it calls pool_resize_launch.

#include <cuda_runtime.h>

namespace {

__global__ void pool_resize_kernel(
    const float* __restrict__ frames, unsigned char* __restrict__ out,
    const int* __restrict__ row_start, const int* __restrict__ row_count,
    const float* __restrict__ row_w, const int* __restrict__ col_start,
    const int* __restrict__ col_count, const float* __restrict__ col_w,
    const int* __restrict__ tile_r0, const int* __restrict__ tile_nr,
    int H, int W, int h, int w, int KH, int KW, int TH) {
  extern __shared__ float pooled[];  // [tile_nr[tile], W]
  const int n = blockIdx.x;
  const int tile = blockIdx.y;
  const int o0 = tile * TH;
  const int o1 = min(o0 + TH, h);
  const int r0 = tile_r0[tile];
  const int nr = tile_nr[tile];

  const size_t plane = static_cast<size_t>(H) * W;
  const float* f0 = frames + static_cast<size_t>(n) * 2 * plane +
                    static_cast<size_t>(r0) * W;
  const float* f1 = f0 + plane;
  for (int i = threadIdx.x; i < nr * W; i += blockDim.x) {
    pooled[i] = fmaxf(f0[i], f1[i]);
  }
  __syncthreads();

  unsigned char* dst = out + static_cast<size_t>(n) * h * w;
  const int pixels = (o1 - o0) * w;
  for (int i = threadIdx.x; i < pixels; i += blockDim.x) {
    const int o = o0 + i / w;
    const int p = i - (i / w) * w;
    const int rs = row_start[o] - r0;
    const int rc = row_count[o];
    const int cs = col_start[p];
    const int cc = col_count[p];
    const float* wr = row_w + o * KH;
    const float* wc = col_w + p * KW;
    float acc = 0.0f;
    for (int j = 0; j < cc; ++j) {
      const float* src = pooled + rs * W + cs + j;
      float t = 0.0f;
      for (int k = 0; k < rc; ++k) {
        t += wr[k] * src[k * W];
      }
      acc += t * wc[j];
    }
    const int v = min(max(__float2int_rn(acc), 0), 255);
    dst[o * w + p] = static_cast<unsigned char>(v);
  }
}

}  // namespace

extern "C" int pool_resize_launch(
    const float* frames, unsigned char* out, const int* row_start,
    const int* row_count, const float* row_w, const int* col_start,
    const int* col_count, const float* col_w, const int* tile_r0,
    const int* tile_nr, int n, int H, int W, int h, int w, int KH, int KW,
    int TH, int max_tile_rows, void* stream) {
  const size_t smem = static_cast<size_t>(max_tile_rows) * W * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pool_resize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n, (h + TH - 1) / TH);
  pool_resize_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, out, row_start, row_count, row_w, col_start, col_count, col_w,
      tile_r0, tile_nr, H, W, h, w, KH, KW, TH);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pool_resize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
