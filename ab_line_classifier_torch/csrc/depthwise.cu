// Depthwise K x K convolution, stride 1, zero SAME padding, for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/depthwise_pallas.py::_kernel.
// That kernel shift-MACs whole (W-sublane x C-lane) tiles held in VMEM and
// groups its terms by column shift, because a W-offset slice is a sublane
// relayout on the TPU. A GPU has no such cost: here every thread computes
// one output element
//
//   y[b, yo, xo, c] =
//       sum_{dw} sum_{dh} x[b, yo+dh-P, xo+dw-P, c] * w[dh, dw, c]
//
// with float32 accumulation, the terms summed dw outer and dh inner, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, so no FMA
// contraction). Taps that fall in the zero padding are skipped; in the
// plain PyTorch version (ops/depthwise.py::depthwise_plain) they add a zero,
// which leaves the sum unchanged, so the two agree exactly.
//
// Bound: bytes. A K x K depthwise conv does 2K^2 FLOP per element and, in
// bf16, must move 4 bytes per element (one read of x, one write of y): 4.5
// FLOP/byte at K=3 and 12.5 at K=5, below the H100's ~20 FLOP/byte of
// float32 CUDA-core rate over HBM bandwidth. So the design aims only at
// touching each byte of x and y once in device memory: channels are the
// fastest index of both the threads and the NHWC layout, so a warp's load
// of one tap is one contiguous run, and the K^2-fold reuse of each input
// element across neighbouring outputs comes from L1/L2, not from HBM.
//
// Layout: one block per output row (b, yo); its threads walk the row's
// W x C elements. Row offsets are 64-bit: an f32 [2048, 64, 64, 128] input
// is past 2^31 bytes. The weight is float32 [K, K, C], repacked once per
// layer by the wrapper (ops/depthwise_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int K>
__global__ void depthwise_kernel(const T* __restrict__ x,
                                 const float* __restrict__ w,
                                 T* __restrict__ y, int h, int wd, int c) {
  constexpr int P = K / 2;
  const int64_t row = blockIdx.x;  // b * h + yo
  const int64_t b = row / h;
  const int yo = static_cast<int>(row - b * h);
  const int64_t rowlen = static_cast<int64_t>(wd) * c;
  const T* frame = x + b * h * rowlen;
  T* out = y + row * rowlen;
  for (int j = threadIdx.x; j < rowlen; j += blockDim.x) {
    const int xo = j / c;
    const int ch = j - xo * c;
    float acc = 0.0f;
#pragma unroll
    for (int dw = 0; dw < K; ++dw) {
      const int xi = xo + dw - P;
      if (xi < 0 || xi >= wd) continue;
#pragma unroll
      for (int dh = 0; dh < K; ++dh) {
        const int yi = yo + dh - P;
        if (yi < 0 || yi >= h) continue;
        const float v =
            load(frame + yi * rowlen + static_cast<int64_t>(xi) * c + ch);
        acc = __fadd_rn(acc, __fmul_rn(v, w[(dh * K + dw) * c + ch]));
      }
    }
    store(out + j, acc);
  }
}

template <typename T>
cudaError_t launch(const T* x, const float* w, T* y, long long rows, int h,
                   int wd, int c, int k, cudaStream_t st) {
  const long long rowlen = static_cast<long long>(wd) * c;
  const int threads =
      rowlen >= 256 ? 256 : static_cast<int>((rowlen + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned int>(rows));
  void (*kernel)(const T*, const float*, T*, int, int, int);
  switch (k) {
    case 1: kernel = depthwise_kernel<T, 1>; break;
    case 3: kernel = depthwise_kernel<T, 3>; break;
    case 5: kernel = depthwise_kernel<T, 5>; break;
    case 7: kernel = depthwise_kernel<T, 7>; break;
    default: return cudaErrorInvalidValue;
  }
  kernel<<<grid, threads, 0, st>>>(x, w, y, h, wd, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). x and y are NHWC [rows / h, h, wd, c]; `rows` (batch * h) is
// below 2^31 and wd * c below 2^31 (checked by the caller).
int ablc_depthwise(const void* x, const void* w, void* y, int is_bf16,
                   long long rows, int h, int wd, int c, int k, void* stream) {
  if (rows <= 0 || wd <= 0 || c <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) {
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x), wf,
                                   static_cast<__nv_bfloat16*>(y), rows, h, wd,
                                   c, k, st));
  }
  return static_cast<int>(launch(static_cast<const float*>(x), wf,
                                 static_cast<float*>(y), rows, h, wd, c, k,
                                 st));
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
