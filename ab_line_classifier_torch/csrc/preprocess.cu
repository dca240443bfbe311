// Fused frame -> model-input preprocessing for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/preprocess_pallas.py
// ::_preprocess_kernel. That kernel does the nearest-neighbour resize as two
// 0/1 selection matmuls because the TPU has no vector gather; a GPU gathers
// natively, so here every thread simply reads the source pixel its output
// pixel maps to:
//
//   out[b, y, x, c] = src[b, ridx[y], cidx[x], perm[c]] * scale[c] * m + bias[c]
//
// where m is the beam-mask value at (ridx[y], cidx[x]) (1 without a mask)
// and 0 inside the UI-blank box. The affine runs in float32 as a rounded
// multiply, a multiply by m and a rounded add (__fmul_rn / __fadd_rn, so no
// FMA contraction), which is bit for bit what the plain PyTorch version
// ops/image.py::fused_preprocess computes for binary masks. The mask is used
// as a float here, as in the Pallas kernel; the plain version casts it to
// uint8 first, as the reference's XLA path does. The two agree only for 0/1
// masks.
//
// The kernel is bound by bytes moved: it reads each gathered source pixel
// once (3 bytes; at a 5-pixel column stride nearly every 32-byte sector of a
// needed source row is touched) and writes each output pixel once, as
// contiguous NHWC, so out.permute(0, 3, 1, 2) is already the channels_last
// NCHW tensor the convolutions read. It does no arithmetic worth counting.
//
// Layout: one block per output row (b, y); its threads walk x. Offsets into
// the source are 64-bit: 2048 frames of 1080x1440x3 is 9.6e9 bytes.
// Any source size is accepted: there is no fast-memory budget to respect.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Affine {
  int perm[3];
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void preprocess_kernel(const uint8_t* __restrict__ src,
                                  OutT* __restrict__ out, int hs, int ws,
                                  int hd, int wd,
                                  const int* __restrict__ ridx,
                                  const int* __restrict__ cidx,
                                  const float* __restrict__ mask, int blank_h,
                                  int blank_w, Affine a) {
  const int64_t row = blockIdx.x;  // b * hd + y
  const int64_t b = row / hd;
  const int y = static_cast<int>(row - b * hd);
  const int sy = ridx[y];
  const uint8_t* src_row = src + (b * hs + sy) * static_cast<int64_t>(ws) * 3;
  OutT* out_row = out + row * static_cast<int64_t>(wd) * 3;
  const bool row_blank = sy < blank_h;
  for (int x = threadIdx.x; x < wd; x += blockDim.x) {
    const int sx = cidx[x];
    const uint8_t* px = src_row + static_cast<int64_t>(sx) * 3;
    float m = 1.0f;
    if (mask != nullptr) m = mask[static_cast<int64_t>(sy) * ws + sx];
    if (row_blank && sx < blank_w) m = 0.0f;
    const float v0 = px[0], v1 = px[1], v2 = px[2];
    OutT* o = out_row + static_cast<int64_t>(x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // Select rather than index a local array, which would spill it.
      const int p = a.perm[c];
      const float v = p == 0 ? v0 : (p == 1 ? v1 : v2);
      const float s = __fmul_rn(__fmul_rn(v, a.scale[c]), m);
      store(o + c, __fadd_rn(s, a.bias[c]));
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). `rows` is batch * hd, at most 2^31 - 1 (checked by the caller).
int ablc_preprocess(const void* src, void* out, int out_is_bf16,
                    long long rows, int hs, int ws, int hd, int wd,
                    const void* ridx, const void* cidx, const void* mask,
                    int blank_h, int blank_w, int p0, int p1, int p2, float s0,
                    float s1, float s2, float b0, float b1, float b2,
                    void* stream) {
  if (rows <= 0) return 0;
  const Affine a = {{p0, p1, p2}, {s0, s1, s2}, {b0, b1, b2}};
  const int threads = wd >= 128 ? 128 : ((wd + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned int>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int* r = static_cast<const int*>(ridx);
  const int* c = static_cast<const int*>(cidx);
  const float* m = static_cast<const float*>(mask);
  if (out_is_bf16) {
    preprocess_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        s, static_cast<__nv_bfloat16*>(out), hs, ws, hd, wd, r, c, m, blank_h,
        blank_w, a);
  } else {
    preprocess_kernel<float><<<grid, threads, 0, st>>>(
        s, static_cast<float*>(out), hs, ws, hd, wd, r, c, m, blank_h, blank_w,
        a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
