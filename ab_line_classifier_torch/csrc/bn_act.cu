// Frozen batch norm and the activation that reads it, for Hopper (sm_90a):
// one pass over device memory.
//
// Replaces no TPU kernel. On the TPU, XLA fuses an inference batch norm's
// affine and the activation after it into the conv before them. In the
// port, a batch norm that normalizes with its running statistics
// (serving, Grad-CAM's frozen prefix, a frozen layer in training) ran as
// ATen's F.batch_norm: a side kernel for the per-channel inverse deviation,
// then batch_norm_transform_input_channels_last_kernel (about half of its
// bytes bound on this card, and slower still past 2^31 elements), its
// output rounded to bf16; then the activation (ReLU, ReLU6's clamp, or
// swish: F.silu) read and wrote the whole tensor again. At
// efficientnetb7's 256 x 600x600 chunk that is 562 GB a forward for its 163
// batch norms and 108 swishes; this pass moves 297 GB (each batch norm's
// input read once and its output, or its activation's, written once).
//
// For x NHWC [n, h, w, c] in T (bf16 or float32) and float32 [c] vectors
// mean, var, weight (or none: 1) and bias, it computes per element, in
// float32 and in the order ATen's eval batch norm computes it,
//
//   inv = rsqrtf(var + eps)                batch_norm_calc_invstd
//   y = fma(weight * (x - mean), inv, bias)
//   y = T(y)                               F.batch_norm's output
//   y = T(act(y))                          none, ReLU, ReLU6 or swish
//
// so the pass is bit-equal to the library chain it replaces (ATen computes
// y as above, past 2^31 elements too). The activation reads y as the
// library's activation reads F.batch_norm's output, rounded to T: for
// none, ReLU and ReLU6 that rounding commutes with the activation; for
// swish it does not, so the pass rounds twice, as the chain does, and its
// answers stay the library's.
// The activations keep PyTorch's NaN rules: ReLU and ReLU6 pass a NaN
// through (clamp_min, clamp), ReLU6 clamps +inf to 6 and -inf to 0, and
// swish is ATen's SiLU, y / (1 + exp(-y)) (NaN at -inf, as there). The
// intrinsics (__fsub_rn, __fmul_rn, __fmaf_rn) fix each rounding, so no
// contraction of the compiler's can reorder it.
//
// Bound: bytes. An element costs a subtract, a multiply, a multiply-add and
// a rounding, and at most an exp and a divide, against 4 (bf16) or 8
// (float32) bytes moved.
// So the design keeps the memory system full, as the conv epilogue does:
//
// - 16-byte vectors: a thread moves 8 bf16 or 4 float32 channels per access,
//   neighbouring threads on neighbouring vectors.
// - Persistent blocks: as many blocks as fit on the card at once
//   (ops/bn_act_cuda.py::launch_grid) walk the vectors with a grid-sized
//   stride that is a multiple of c's vectors a pixel, so a thread's channels
//   never change: it reads their mean, weight and bias and derives their
//   inverse deviation once, into registers (no side kernel, and a training
//   step that has just moved the statistics is read as it left them).
// - Bytes in flight: a thread issues kUnroll vector loads before it uses
//   any.
// - 64-bit offsets: efficientnetb7's block2a expand batch norm is 4.42 G
//   elements a 256 chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2, kSwish = 3 };

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
  // y rounded to T, as float.
  __device__ __forceinline__ static float round(float y) {
    return __bfloat162float(__float2bfloat16_rn(y));
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
  __device__ __forceinline__ static float round(float y) { return y; }
};

// NaN test that no contraction or fast-math flag can fold away (the build
// uses neither).
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

template <int kAct>
__device__ __forceinline__ float activate(float y) {
  if (kAct == kRelu) return is_nan(y) ? y : fmaxf(y, 0.0f);
  if (kAct == kRelu6) return is_nan(y) ? y : fminf(fmaxf(y, 0.0f), 6.0f);
  if (kAct == kSwish) return y / (1.0f + expf(-y));
  return y;
}

// Over `units` 16-byte vectors of x into out, `cvecs` of them a pixel. The
// grid's stride is a multiple of cvecs (the launch's contract).
template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
    batch_norm_act_kernel(const uint4* __restrict__ x,
                          uint4* __restrict__ out,
                          const float* __restrict__ mean,
                          const float* __restrict__ var,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias, float eps,
                          long long units, int cvecs) {
  constexpr int V = Lanes<T>::kN;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (first >= units) return;
  // This thread's channels, the same at every step.
  const int c0 = static_cast<int>(first % cvecs) * V;
  float m[V], w[V], inv[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = mean[c0 + i];
    w[i] = weight == nullptr ? 1.0f : weight[c0 + i];
    inv[i] = rsqrtf(var[c0 + i] + eps);
    b[i] = bias[c0 + i];
  }
  for (long long u = first; u < units; u += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (u + j * stride < units) v[j] = __ldg(x + u + j * stride);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u + j * stride < units) {
        float f[V];
        Lanes<T>::unpack(v[j], f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float y = __fmaf_rn(
              __fmul_rn(w[i], __fsub_rn(f[i], m[i])), inv[i], b[i]);
          f[i] = activate<kAct>(Lanes<T>::round(y));
        }
        out[u + j * stride] = Lanes<T>::pack(f);
      }
    }
  }
}

template <typename T>
const void* kernel_of(int act) {
  switch (act) {
    case kRelu:
      return reinterpret_cast<const void*>(batch_norm_act_kernel<T, kRelu>);
    case kRelu6:
      return reinterpret_cast<const void*>(batch_norm_act_kernel<T, kRelu6>);
    case kSwish:
      return reinterpret_cast<const void*>(batch_norm_act_kernel<T, kSwish>);
    default:
      return reinterpret_cast<const void*>(batch_norm_act_kernel<T, kNone>);
  }
}

// The variant (dtype, activation), for the launch and the occupancy query.
const void* kernel_of(int is_bf16, int act) {
  return is_bf16 ? kernel_of<__nv_bfloat16>(act) : kernel_of<float>(act);
}

}  // namespace

extern "C" {

// Launches the pass on `stream` and returns the launch's error (0 on
// success). x and out are NHWC [n, h, w, c] memory of `units` = n * h * w *
// cvecs 16-byte vectors, 16-byte aligned, c a whole number `cvecs` of them;
// mean, var, bias and weight (null: none) float32 [c]. act: 0 none, 1 ReLU,
// 2 ReLU6, 3 swish. Blocks of 256 threads; grid * 256 a multiple of cvecs
// and below 2^31.
int ablc_bn_act(const void* x, void* out, const void* mean, const void* var,
                const void* weight, const void* bias, float eps, int is_bf16,
                int act, long long units, int cvecs, int grid, void* stream) {
  if (units == 0) return 0;
  if (cvecs <= 0 || grid <= 0 || act < kNone || act > kSwish ||
      (static_cast<long long>(grid) * kThreads) % cvecs != 0)
    return cudaErrorInvalidValue;
  void* args[] = {&x, &out, &mean, &var, &weight, &bias, &eps, &units, &cvecs};
  return static_cast<int>(cudaLaunchKernel(
      kernel_of(is_bf16, act), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// Blocks of the variant (dtype, activation) that fit on one SM at once
// (registers included), or -1 on error.
int ablc_bn_act_blocks_per_sm(int is_bf16, int act) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(is_bf16, act), kThreads, 0) != cudaSuccess)
    return -1;
  return n;
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
