// Depthwise K x K convolution, stride 1, zero SAME padding, for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/depthwise_pallas.py::_kernel,
// which shift-MACs whole (W-sublane x C-lane) tiles held in VMEM and groups
// its terms by column shift because a W-offset slice is a sublane relayout
// on the TPU. It computes
//
//   y[b, yo, xo, c] =
//       sum_{dw} sum_{dh} x[b, yo+dh-P, xo+dw-P, c] * w[dh, dw, c]
//
// with float32 accumulation, the terms summed dw outer and dh inner, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, so no FMA
// contraction). Taps in the zero padding are skipped or added as 0 * w;
// the plain PyTorch version (ops/depthwise.py::depthwise_plain) adds them
// as 0 * w, which leaves the sum unchanged, so the two agree exactly.
//
// Bound: bytes. In bf16 a K x K depthwise conv moves 4 bytes per element
// (one read of x, one write of y) for 2K^2 FLOP: 4.5 FLOP/byte at K = 3,
// below the H100's ~20 FLOP/byte of float32 CUDA-core rate over HBM
// bandwidth. Tensor cores do not apply: there is no contraction over
// channels, only K^2 independent multiply-adds per output, and the rounded
// multiply and add are two instructions where an FMA would be one. So the
// float32 pipe is busy for a real share of the time too (at K = 3 about
// half of the memory time), and the design is about keeping every other
// instruction few and the memory system fed while the arithmetic runs:
//
// - Tiles and persistent blocks (depthwise_tiled): the output is cut into
//   tiles of TH rows x blockDim.y columns x blockDim.x channel vectors of
//   one frame; a block per SM slot walks them, and while it computes one
//   tile from shared memory, cp.async copies the next tile's input window
//   into the other buffer. The window's rows outside the frame are zeros,
//   so the inner loop has no row checks (those rows add 0 * w).
// - Wide accesses: a thread owns V consecutive channels, one 16-byte vector
//   (V = 8 in bf16, 4 in float32); neighbouring threads own neighbouring
//   vectors and columns, so a warp's copies and stores are contiguous runs.
// - Reuse in registers: a thread computes TH output rows of one column. For
//   each column shift dw it reads the TH + K - 1 window rows of column
//   xo + dw - P once and adds each into the (up to) K outputs it touches,
//   so an output costs K (TH + K - 1) / TH vector reads and conversions,
//   not K^2. Visiting the rows in increasing order inside each dw gives
//   every output its terms dh = 0..K-1 in order.
// - Weights: the K taps of column dw, V channels each, are loaded once per
//   dw and tile into registers and used for all TH rows.
// - No division per element: tiles are numbered channel tile fastest, and
//   a block steps from tile to tile by adding the grid's digits.
// - Any C and alignment: a tensor whose C is not a multiple of V, or whose
//   data is not 16-byte aligned, runs depthwise_scalar instead, one channel
//   a thread read through L1, with the same tiles and arithmetic.
//
// ops/depthwise_cuda.py::launch_geometry picks the kernel, TH and the
// block; its CPU test checks that the tiles cover every output exactly
// once. Offsets are 64-bit: an f32 [2048, 64, 64, 128] input is past 2^31
// bytes. The weight is float32 [K, K, C], repacked once per layer by the
// wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// V channels of type T as they sit in memory: one 16-byte vector, or one
// element for V = 1.
template <typename T, int V> struct Raw;
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 1> { using type = float; };

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

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  v[0] = bf16_lo(r.x); v[1] = bf16_hi(r.x);
  v[2] = bf16_lo(r.y); v[3] = bf16_hi(r.y);
  v[4] = bf16_lo(r.z); v[5] = bf16_hi(r.z);
  v[6] = bf16_lo(r.w); v[7] = bf16_hi(r.w);
}
__device__ __forceinline__ void unpack(unsigned short r, float (&v)[1]) {
  v[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);
}
__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(float r, float (&v)[1]) { v[0] = r; }

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
      bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

template <int V>
__device__ __forceinline__ void load_weights(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + e));
      v[e] = q.x; v[e + 1] = q.y; v[e + 2] = q.z; v[e + 3] = q.w;
    }
  }
}

// The TH + K - 1 input rows a column shift reads, starting at row r0 - P:
// row i at p[i * stride].
template <typename R, typename S>
struct Column {
  const R* p;
  S stride;
  __device__ __forceinline__ R operator[](int i) const {
    return p[i * stride];
  }
};

// One thread's TH output rows of V channels at column xo, rows r0.., in
// the plain version's order: for each column shift dw, the TH + K - 1 input
// rows of column xo + dw - P (column(xi)) are read once and added, in
// increasing row order, into the outputs they are tap dh = i - t of.
// Columns in the zero padding are skipped; so are rows when ROWS_CHECKED.
// Otherwise the rows outside the frame read as zeros and add 0 * w, every
// output's first term (dw = 0, dh = 0) is there whenever shift 0 is, and
// the sum starts from that product instead of from 0 + it.
template <typename T, int K, int V, int TH, bool ROWS_CHECKED, typename Cols>
__device__ __forceinline__ void accumulate(float (&acc)[TH][V],
                                           const float* __restrict__ w, int c,
                                           int ch, int xo, int wd, int r0,
                                           int h, Cols column) {
  using R = typename Raw<T, V>::type;
  constexpr int P = K / 2;
  constexpr int NR = TH + K - 1;
  if (ROWS_CHECKED || xo < P) {  // shift 0 is skipped: start from 0
#pragma unroll
    for (int t = 0; t < TH; ++t)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[t][e] = 0.0f;
  }
#pragma unroll
  for (int dw = 0; dw < K; ++dw) {
    const int xi = xo + dw - P;
    if (xi < 0 || xi >= wd) continue;
    float wt[K][V];
#pragma unroll
    for (int dh = 0; dh < K; ++dh)
      load_weights<V>(w + (dh * K + dw) * c + ch, wt[dh]);
    const auto col = column(xi);
    R raw[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      if (!ROWS_CHECKED || (r0 - P + i >= 0 && r0 - P + i < h))
        raw[i] = col[i];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (ROWS_CHECKED && (r0 - P + i < 0 || r0 - P + i >= h)) continue;
      float v[V];
      unpack(raw[i], v);
#pragma unroll
      for (int t = 0; t < TH; ++t) {
        const int dh = i - t;
        if (dh < 0 || dh >= K) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float term = __fmul_rn(v[e], wt[dh][e]);
          acc[t][e] = !ROWS_CHECKED && dw == 0 && dh == 0
                          ? term
                          : __fadd_rn(acc[t][e], term);
        }
      }
    }
  }
}

// The output split into tiles of TH rows x blockDim.y columns x
// blockDim.x channel vectors of one frame, numbered channel tile fastest,
// then column tile, row tile and frame.
struct Tiles {
  int h, wd, c, row_tiles, col_tiles, ch_tiles, count;
};

// Tile number t as digits: channel tile ct, column tile wt, row tile rt,
// frame b.
struct Tile {
  int ct, wt, rt, b;
};

__device__ __forceinline__ Tile tile_at(int t, const Tiles& s) {
  const int ct = t % s.ch_tiles;
  t /= s.ch_tiles;
  const int wt = t % s.col_tiles;
  t /= s.col_tiles;
  return {ct, wt, t % s.row_tiles, t / s.row_tiles};
}

// Tile number a + d from a and d's digits, without division: each digit
// sum carries at most once.
__device__ __forceinline__ Tile tile_add(const Tile& a, const Tile& d,
                                         const Tiles& s) {
  Tile r;
  r.ct = a.ct + d.ct;
  const int c0 = r.ct >= s.ch_tiles;
  r.ct -= c0 * s.ch_tiles;
  r.wt = a.wt + d.wt + c0;
  const int c1 = r.wt >= s.col_tiles;
  r.wt -= c1 * s.col_tiles;
  r.rt = a.rt + d.rt + c1;
  const int c2 = r.rt >= s.row_tiles;
  r.rt -= c2 * s.row_tiles;
  r.b = a.b + d.b + c2;
  return r;
}

template <typename T, int V, int TH>
__device__ __forceinline__ void store_rows(T* __restrict__ y, const Tiles& s,
                                           int b, int r0, int xo, int ch,
                                           const float (&acc)[TH][V]) {
  const int64_t row_stride = static_cast<int64_t>(s.wd) * s.c;
  T* out = y + (static_cast<int64_t>(b) * s.h + r0) * row_stride +
           static_cast<int64_t>(xo) * s.c + ch;
#pragma unroll
  for (int t = 0; t < TH; ++t)
    if (r0 + t < s.h) store(out + t * row_stride, acc[t]);
}

// Any C and alignment (V = 1): one block per tile, input rows read from
// global memory through L1.
template <typename T, int K, int TH>
__global__ void __launch_bounds__(256)
depthwise_scalar(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ y, Tiles s) {
  using R = typename Raw<T, 1>::type;
  constexpr int P = K / 2;
  const Tile tl = tile_at(blockIdx.x, s);
  const int cv = tl.ct * blockDim.x + threadIdx.x;
  const int xo = tl.wt * blockDim.y + threadIdx.y;
  const int r0 = tl.rt * TH;
  if (cv >= s.c || xo >= s.wd) return;
  const int64_t row_stride = static_cast<int64_t>(s.wd) * s.c;
  const R* frame = reinterpret_cast<const R*>(x) +
                   (static_cast<int64_t>(tl.b) * s.h + r0 - P) * row_stride +
                   cv;
  float acc[TH][1];
  accumulate<T, K, 1, TH, true>(
      acc, w, s.c, cv, xo, s.wd, r0, s.h, [&](int xi) {
        return Column<R, int64_t>{frame + static_cast<int64_t>(xi) * s.c,
                                  row_stride};
      });
  store_rows<T, 1, TH>(y, s, tl.b, r0, xo, cv, acc);
}

// Copies 16 bytes from src, or writes 16 zero bytes and reads nothing
// when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

// 16-byte vectors (C a multiple of V, x, w and y aligned): persistent
// blocks walk the tiles; each tile's input window is copied into shared
// memory with cp.async while the block computes the previous tile from the
// other buffer, so the loads of the next tile overlap this tile's
// arithmetic. The window holds rows r0 - P .. r0 + TH - 1 + P (zeros
// outside the frame, so the arithmetic needs no row checks) of the
// columns x_lo .. of the frame that the tile's shifts reach; the vector of
// window row i, column q, channel vector tx sits at (i * cols + q) *
// blockDim.x + tx, so a warp's reads and writes of one row are contiguous.
template <typename T, int K, int V, int TH>
__global__ void __launch_bounds__(256)
depthwise_tiled(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, Tiles s, int buffer_vectors) {
  using R = typename Raw<T, V>::type;
  static_assert(sizeof(R) == 16, "the tiled kernel moves 16-byte vectors");
  constexpr int P = K / 2;
  constexpr int NR = TH + K - 1;
  extern __shared__ uint4 smem[];
  R* const base = reinterpret_cast<R*>(smem);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int64_t row_stride = static_cast<int64_t>(s.wd) * s.c;

  auto fetch = [&](const Tile& tl, R* buf) {
    const int cv = tl.ct * bx + tx;
    if (cv * V >= s.c) return;
    const int x0 = tl.wt * by, r0 = tl.rt * TH;
    const int x_lo = max(0, x0 - P);
    const int cols = min(s.wd, x0 + by + P) - x_lo;
    const T* frame = x + static_cast<int64_t>(tl.b) * s.h * row_stride +
                     static_cast<int64_t>(cv) * V;
    for (int q = ty; q < cols; q += by) {
      // Row 0 of the column: where a row outside the frame points, though
      // nothing is read for it.
      const T* col = frame + static_cast<int64_t>(x_lo + q) * s.c;
      const T* src = col + static_cast<int64_t>(r0 - P) * row_stride;
      R* dst = buf + q * bx + tx;
#pragma unroll
      for (int i = 0; i < NR; ++i, src += row_stride) {
        const bool in = static_cast<unsigned int>(r0 - P + i) <
                        static_cast<unsigned int>(s.h);
        cp_async16(dst + i * cols * bx, in ? src : col, in);
      }
    }
  };

  if (static_cast<int>(blockIdx.x) >= s.count) return;
  const Tile step = tile_at(gridDim.x, s);
  const int frames = s.count / (s.row_tiles * s.col_tiles * s.ch_tiles);
  Tile tl = tile_at(blockIdx.x, s);
  fetch(tl, base);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int cur = 0; tl.b < frames; cur ^= 1) {
    const Tile next = tile_add(tl, step, s);
    if (next.b < frames) fetch(next, base + (cur ^ 1) * buffer_vectors);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int cv = tl.ct * bx + tx;
    const int x0 = tl.wt * by, r0 = tl.rt * TH;
    const int xo = x0 + ty;
    if (cv * V < s.c && xo < s.wd) {
      const int x_lo = max(0, x0 - P);
      const int cols = min(s.wd, x0 + by + P) - x_lo;
      const R* buf = base + cur * buffer_vectors + tx;
      float acc[TH][V];
      accumulate<T, K, V, TH, false>(
          acc, w, s.c, cv * V, xo, s.wd, r0, s.h, [&](int xi) {
            return Column<R, int>{buf + (xi - x_lo) * bx, cols * bx};
          });
      store_rows<T, V, TH>(y, s, tl.b, r0, xo, cv * V, acc);
    }
    __syncthreads();
    tl = next;
  }
}

template <typename T, int K, int TH>
cudaError_t launch_kernel(int vec, const T* x, const float* w, T* y,
                          const Tiles& s, dim3 block, int smem_bytes,
                          cudaStream_t st) {
  if (vec == 1) {
    depthwise_scalar<T, K, TH><<<s.count, block, 0, st>>>(x, w, y, s);
    return cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(T);
  if (vec != V) return cudaErrorInvalidValue;
  auto kernel = depthwise_tiled<T, K, V, TH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block.x * block.y, smem_bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int grid = s.count < per_sm * sms ? s.count : per_sm * sms;
  kernel<<<grid, block, smem_bytes, st>>>(x, w, y, s, smem_bytes / 32);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_rows(int rows, int vec, const T* x, const float* w, T* y,
                        const Tiles& s, dim3 block, int smem_bytes,
                        cudaStream_t st) {
  switch (rows) {
    case 4: return launch_kernel<T, K, 4>(vec, x, w, y, s, block, smem_bytes,
                                          st);
    case 8: return launch_kernel<T, K, 8>(vec, x, w, y, s, block, smem_bytes,
                                          st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int k, int rows, int vec, const void* x, const float* w,
                   void* y, const Tiles& s, dim3 block, int smem_bytes,
                   cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (k) {
    case 1: return launch_rows<T, 1>(rows, vec, xt, w, yt, s, block,
                                     smem_bytes, st);
    case 3: return launch_rows<T, 3>(rows, vec, xt, w, yt, s, block,
                                     smem_bytes, st);
    case 5: return launch_rows<T, 5>(rows, vec, xt, w, yt, s, block,
                                     smem_bytes, st);
    case 7: return launch_rows<T, 7>(rows, vec, xt, w, yt, s, block,
                                     smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t (0 on success).
// x and y are NHWC [b, h, wd, c]. The caller's launch geometry
// (ops/depthwise_cuda.py::launch_geometry) gives `vec` channels per thread
// (16 / itemsize, with c a multiple of it and 16-byte aligned x, w and y:
// the tiled kernel, as many blocks as fit on the card at once; or 1: the
// scalar kernel, a block per tile), `rows` output rows per thread (4 or
// 8), the block (bx channel vectors x by columns, at most 256 threads),
// the tile counts (b * row_tiles * col_tiles * ch_tiles tiles, below 2^31)
// and the tiled kernel's shared memory (two window buffers).
int ablc_depthwise(const void* x, const void* w, void* y, int is_bf16, int k,
                   int vec, int rows, int b, int h, int wd, int c,
                   int row_tiles, int col_tiles, int ch_tiles, int bx, int by,
                   int smem_bytes, void* stream) {
  const long long count =
      static_cast<long long>(b) * row_tiles * col_tiles * ch_tiles;
  if (count == 0) return 0;
  if (bx <= 0 || by <= 0 || bx * by > 256 || count >= (1LL << 31))
    return cudaErrorInvalidValue;
  const Tiles s{h, wd, c, row_tiles, col_tiles, ch_tiles,
                static_cast<int>(count)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const dim3 block(bx, by);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(k, rows, vec, x, wf, y, s,
                                                  block, smem_bytes, st));
  return static_cast<int>(
      launch<float>(k, rows, vec, x, wf, y, s, block, smem_bytes, st));
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
