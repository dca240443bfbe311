// Conv epilogue for Hopper (sm_90a): a conv output's bias add, ReLU and,
// where a 2x2 max-pool follows, the pool, in one pass over device memory.
//
// Replaces no TPU kernel. On the TPU, XLA fuses a conv's bias, activation
// and pool into the conv's own output. In the port, cuDNN runs the conv
// without its bias, and PyTorch then adds the bias (output.add_(bias), a
// broadcast add that runs unvectorised), applies the ReLU (clamp_min) and
// max-pools (max_pool2d_with_indices, which also writes int64 indices the
// forward never reads): three passes that each read the conv's output
// again. At 2048 frames of 128x128 through cutoffvgg16's seven convs that
// is 72.5 GB a forward; this pass moves 27.4 GB (each conv output read
// once, the five unpooled ones written once in place, the two pooled ones
// written as their quarter).
//
// For y NHWC [n, h, w, c] in T (bf16 or float32) and bias[c] in T it
// computes, per element,
//
//   r = T(float(y) + float(bias))            PyTorch's add_: one rounding
//   r = isnan(r) ? r : fmaxf(r, 0)           the ReLU (clamp_min), if asked
//
// and either writes r back into y (conv_epilogue_kernel), or writes into
// out [n, h / 2, w / 2, c] the max of each 2x2 window of r, rows 2i, 2i+1
// and columns 2j, 2j+1 (a last odd row or column is dropped, as VALID
// drops it), taken as PyTorch's NHWC max-pool takes it: from -inf, in
// row-major order, a NaN replacing the max whenever one is met
// (conv_epilogue_pool_kernel). The same operations in the same order, so
// the result is bit-equal to the library chain, NaN and signed zeros
// included.
//
// Bound: bytes. An element costs one add and a compare or two against 4
// (bf16) or 8 (float32) bytes moved, far below the card's operations per
// byte. So the design is about keeping the memory system full:
//
// - 16-byte vectors: a thread moves 8 bf16 or 4 float32 channels per access,
//   neighbouring threads on neighbouring vectors, so a warp reads and writes
//   contiguous 512-byte runs (the pool's window loads of one output row
//   interleave: its (0, 0) and (0, 1) loads together cover each input row
//   pair's bytes once).
// - Persistent blocks: as many blocks as fit on the card at once
//   (ops/conv_epilogue_cuda.py::launch_geometry, from the runtime's
//   occupancy) walk the vectors with a grid-sized stride. The block size is
//   a multiple of c's vectors, so a thread's channels never change: its
//   bias vector is loaded once, into registers.
// - Bytes in flight: in place, a thread issues kUnroll vector loads before
//   it uses any; in the pool, its four window loads. At the 1280-1536
//   threads an SM holds at 40-48 registers, that is 80-96 KB an SM in
//   flight, several times what 3.35 TB/s times the memory latency needs, at
//   batch 2048 and at the fit's batch 64 (134 MB for block 1) alike.
// - No division by the channel count per element, and the pool's pixel
//   arithmetic in 32 bits (the wrapper holds n * (h / 2) * (w / 2) below
//   2^31); byte offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float bf16_lo(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ unsigned int bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&p);
}

// The lanes of one 16-byte vector of T, as float, and back.
template <typename T> struct Lanes;

template <> struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(u[i]);
      f[2 * i + 1] = bf16_hi(u[i]);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
  // float(T(s)): the bias sum rounded to bf16, as PyTorch's add_ stores it.
  __device__ __forceinline__ static float round(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
};

template <> struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float s) { return s; }
};

// NaN test that no contraction or fast-math flag can fold away (the build
// uses neither).
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// A vector of y with the bias added, rounded to T and, with kRelu, the ReLU
// taken (clamp_min(r, 0): a NaN stays, else fmaxf(r, 0), as PyTorch's
// kernel computes it), in `f`.
template <typename T, bool kRelu>
__device__ __forceinline__ void bias_relu(const uint4& v, const float* b,
                                          float* f) {
  Lanes<T>::unpack(v, f);
#pragma unroll
  for (int i = 0; i < Lanes<T>::kN; ++i) {
    float r = Lanes<T>::round(f[i] + b[i]);
    if (kRelu && !is_nan(r)) r = fmaxf(r, 0.0f);
    f[i] = r;
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// This thread's bias vector (its channels are the same at every step).
template <typename T>
__device__ __forceinline__ void load_bias(const T* bias, int cv, float* b) {
#pragma unroll
  for (int i = 0; i < Lanes<T>::kN; ++i)
    b[i] = to_float(bias[cv * Lanes<T>::kN + i]);
}

// In place over `units` 16-byte vectors of y, c / V of them a pixel.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    conv_epilogue_kernel(uint4* __restrict__ y, const T* __restrict__ bias,
                         long long units, int cvecs) {
  constexpr int V = Lanes<T>::kN;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float b[V];
  load_bias(bias, static_cast<int>(first % cvecs), b);
  for (long long u = first; u < units; u += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (u + j * stride < units) v[j] = y[u + j * stride];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u + j * stride < units) {
        float f[V];
        bias_relu<T, kRelu>(v[j], b, f);
        y[u + j * stride] = Lanes<T>::pack(f);
      }
    }
  }
}

// Into out [n, ho, wo, c]: `units` = n * ho * wo * (c / V) vectors.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    conv_epilogue_pool_kernel(const uint4* __restrict__ y,
                              const T* __restrict__ bias,
                              uint4* __restrict__ out, long long units, int h,
                              int w, int ho, int wo, int cvecs) {
  constexpr int V = Lanes<T>::kN;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cv = static_cast<int>(first % cvecs);
  float b[V];
  load_bias(bias, cv, b);
  // Output pixel of unit u: u / cvecs, advancing by stride / cvecs.
  const unsigned int pstep = static_cast<unsigned int>(stride / cvecs);
  unsigned int p = static_cast<unsigned int>(first / cvecs);
  const long long row = static_cast<long long>(w) * cvecs;
  for (long long u = first; u < units; u += stride, p += pstep) {
    const unsigned int ox = p % wo;
    const unsigned int t = p / wo;
    const unsigned int oy = t % ho;
    const unsigned int n = t / ho;
    const long long i =
        ((static_cast<long long>(n) * h + 2 * oy) * w + 2 * ox) * cvecs + cv;
    // Window in PyTorch's order: (0, 0), (0, 1), (1, 0), (1, 1).
    const uint4 v0 = __ldg(y + i);
    const uint4 v1 = __ldg(y + i + cvecs);
    const uint4 v2 = __ldg(y + i + row);
    const uint4 v3 = __ldg(y + i + row + cvecs);
    float m[V], f[V];
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = __uint_as_float(0xff800000u);  // -inf
    const uint4 win[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bias_relu<T, kRelu>(win[q], b, f);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (f[k] > m[k] || is_nan(f[k])) m[k] = f[k];
    }
    out[u] = Lanes<T>::pack(m);
  }
}

template <typename T, bool kRelu>
const void* kernel_of(int pool) {
  return pool ? reinterpret_cast<const void*>(
                    conv_epilogue_pool_kernel<T, kRelu>)
              : reinterpret_cast<const void*>(conv_epilogue_kernel<T, kRelu>);
}

const void* kernel_of(int is_bf16, int relu, int pool) {
  if (is_bf16)
    return relu ? kernel_of<__nv_bfloat16, true>(pool)
                : kernel_of<__nv_bfloat16, false>(pool);
  return relu ? kernel_of<float, true>(pool) : kernel_of<float, false>(pool);
}

template <typename T, bool kRelu>
cudaError_t launch(const void* y, const void* bias, void* out, long long units,
                   int h, int w, int ho, int wo, int cvecs, int grid,
                   int threads, cudaStream_t st) {
  const T* b = static_cast<const T*>(bias);
  if (out == nullptr)
    conv_epilogue_kernel<T, kRelu><<<grid, threads, 0, st>>>(
        static_cast<uint4*>(const_cast<void*>(y)), b, units, cvecs);
  else
    conv_epilogue_pool_kernel<T, kRelu><<<grid, threads, 0, st>>>(
        static_cast<const uint4*>(y), b, static_cast<uint4*>(out), units, h,
        w, ho, wo, cvecs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the epilogue on `stream` and returns cudaGetLastError() (0 on
// success). y is NHWC [n, h, w, c] memory, 16-byte aligned, c a whole
// number `cvecs` of 16-byte vectors; bias [c] of y's dtype. `out` null:
// in place over y's `units` = n * h * w * cvecs vectors; else the 2x2
// max-pool into out [n, ho, wo, c] (16-byte aligned), `units` = n * ho *
// wo * cvecs, n * ho * wo below 2^31. `threads` is a multiple of cvecs of
// at most 256, and grid * threads below 2^31.
int ablc_conv_epilogue(const void* y, const void* bias, void* out,
                       int is_bf16, int relu, long long units, int h, int w,
                       int ho, int wo, int cvecs, int grid, int threads,
                       void* stream) {
  if (units == 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || cvecs <= 0 ||
      threads % cvecs != 0 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(
        relu ? launch<__nv_bfloat16, true>(y, bias, out, units, h, w, ho, wo,
                                           cvecs, grid, threads, st)
             : launch<__nv_bfloat16, false>(y, bias, out, units, h, w, ho, wo,
                                            cvecs, grid, threads, st));
  return static_cast<int>(
      relu ? launch<float, true>(y, bias, out, units, h, w, ho, wo, cvecs,
                                 grid, threads, st)
           : launch<float, false>(y, bias, out, units, h, w, ho, wo, cvecs,
                                  grid, threads, st));
}

// Blocks of `threads` of the variant (dtype, ReLU, pool) that fit on one SM
// at once (registers included), or -1 on error.
int ablc_conv_epilogue_blocks_per_sm(int is_bf16, int relu, int pool,
                                     int threads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(is_bf16, relu, pool), threads, 0) != cudaSuccess)
    return -1;
  return n;
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
