// Kernel bev_epilogue: the epilogue of one lateral of the BEV ResNet, its
// transposed conv's bias and ReLU, written straight into the lateral's
// channel slice of the concatenated map.
//
// Replaces no TPU kernel: XLA fused the JAX package's bias, ReLU and
// concatenation into its convs.  On the card cuDNN cannot fuse an
// epilogue into a transposed conv, and PyTorch ran it as three passes
// over each lateral (a strided bias add, the ReLU, the concatenation's
// copy); the conv now runs without bias and this kernel is the one pass
// after it (model/backbone2d.py).
//
// Contract: y [rows, C] bf16 (the conv's NHWC output, rows = H*W), bias
// [C] bf16, out [rows, >= C] bf16 with a row stride of `ld` elements
// (the slice of a channels_last [1, ld, H, W] map that starts at this
// lateral's first channel).  out[r, c] = bf16(max(float(y[r, c]) +
// float(bias[c]), 0)): the sum in f32, rounded once, as PyTorch's bias add
// rounds it; the ReLU after the rounding gives the same bits (a NaN stays
// NaN, as under torch.maximum).  C, ld and the pointers' element offsets
// are multiples of 8 (16-byte vectors).
//
// What bounds it on the H100: bytes.  A lateral at the 468 x 468 map
// reads and writes 56 MB each, 33 us at 3.35 TB/s; two operations an
// element are nothing.
//
// Design: one thread an 8-channel vector, a grid-stride loop; y and out
// move as 16-byte vectors, consecutive threads consecutive vectors of a
// row, so a warp reads and writes whole rows.  The bias vector comes
// through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bev_epilogue_kernel(const uint4* __restrict__ y, const uint4* __restrict__ bias,
                    uint4* __restrict__ out, long long vectors, int row_vecs,
                    int ld_vecs) {
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       i < vectors; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = i / row_vecs;
    const int v = static_cast<int>(i - r * row_vecs);
    const uint4 a = y[i];
    const uint4 b = __ldg(bias + v);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fa = __bfloat1622float2(ah[k]);
      const float2 fb = __bfloat1622float2(bh[k]);
      const float lo = fa.x + fb.x, hi = fa.y + fb.y;
      oh[k] = __floats2bfloat162_rn(lo < 0.f ? 0.f : lo, hi < 0.f ? 0.f : hi);
    }
    out[r * ld_vecs + v] = o;
  }
}

}  // namespace

extern "C" int dsvt_bev_epilogue(const void* y, const void* bias, void* out,
                                 int rows, int C, int ld, void* stream) {
  if (rows < 1 || C < 8 || C % 8 || ld < C || ld % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vectors = static_cast<long long>(rows) * (C / 8);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (vectors + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  bev_epilogue_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(bias),
      static_cast<uint4*>(out), vectors, C / 8, ld / 8);
  return static_cast<int>(cudaGetLastError());
}
