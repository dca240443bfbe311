// Fused frame -> model-input preprocessing for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/preprocess_pallas.py
// ::_preprocess_kernel. That kernel does the nearest-neighbour resize as two
// 0/1 selection matmuls because the TPU has no vector gather; a GPU gathers
// natively:
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
// masks. A row without a mask or blanked columns skips the multiply by
// m = 1 (exact). A pixel in the UI box is not read: it enters as 0, which
// gives the same bits, since v * scale * 0 is a zero whose sign is scale's
// for any byte v.
//
// Bound: bytes, one read of the source sectors the index map selects and
// one write of the output, as contiguous NHWC (out.permute(0, 3, 1, 2) is
// the channels_last tensor the convolutions read). What held the first
// version of this kernel under its bound at small sources was not the
// arithmetic but the transfers: one block per output row (262,144 blocks
// at 2048 x 128x128), two dependent index loads ahead of every pixel load,
// byte loads and 2-byte stores. Now:
//
// - The output rows are cut into stages of `group` consecutive rows; block
//   b takes stages b, b + gridDim.x, ... over a grid of a few waves of the
//   blocks the card holds at once (ops/preprocess_cuda.py::launch_plan), so
//   the blocks on the card sweep the batch in memory order and 2048 frames
//   of 128 rows are ~34,000 small blocks of several rows each.
// - No index is read: each thread computes its columns' source indices
//   once, in float64 as nearest_indices does (the same indices), and keeps
//   them in registers; a row's source row is computed where it is staged.
// - Staged path (the row's selected columns touch most of its sectors: the
//   identity map, 480x640 and 1080x1440 to 128x128): a lane of warp 0 per
//   row starts one 1-D bulk copy (TMA) of the row's span [lo, hi), widened
//   to 16-byte alignment, into a ring of `stages` shared-memory buffers,
//   completing on the buffer's mbarrier, so the next stages are in flight
//   while this one is computed. Bytes that the tensor's ends cut from a
//   16-byte chunk (a data pointer off the 16-byte grid) are copied by plain
//   loads. Rows of the UI box start their span after the blanked columns.
// - Gather path (sparse maps, e.g. a 4K source to 128, or where every block
//   would take a single row, as at batch 1, and the latency of the first
//   byte is all there is): bytes come straight from global memory.
// - A thread computes P whole pixels (48 bytes of output) into shared
//   memory, in the rows' own layout; one thread then writes the stage with
//   one bulk store (TMA), double-buffered. Rows that are not a whole number
//   of 16-byte vectors take the scalar branch (one pixel a thread, stored by
//   the thread).
// - Bytes become floats by the exponent trick (2^23 + v, minus 2^23:
//   exact); the channel order (caffe's BGR) is a template parameter.
//
// scripts/torch_preprocess_tune.py sweeps the plan's knobs at the paths'
// shapes; tests/test_torch_preprocess_plan.py holds the plan and the index
// arithmetic on the CPU. Offsets into the source are 64-bit: 2048 frames
// of 1080x1440x3 is 9.6e9 bytes. Any source size and any data pointer
// alignment is accepted. Dynamic shared memory stays under 48 KB, so no
// attribute is set and a graph capture records the launch as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Staged buffers at most.
constexpr int kMaxStages = 4;

// Mirrored by ops/preprocess_cuda.py::_Params (ctypes); keep the two in
// the same order.
struct Params {
  double scale_h, scale_w;  // hs / hd and ws / wd, as numpy computes them
  long long rows;           // batch * hd output rows (< 2^31)
  long long src_bytes;      // batch * hs * ws * 3
  int hs, ws, hd, wd;
  int cv2;            // the index map: cv2's floor(i * s), else TF's
  int lo, hi;         // a source row's selected bytes, [lo, hi)
  int lo_blank;       // the span's start in a row of the UI box
  int xb;             // output columns blanked in a row of the UI box
  int blank_h;        // source rows of the UI box (0: no blank)
  int slot;           // bytes of one staged row, a multiple of 16
  int group;          // output rows per stage
  int stages;         // staged buffers in the ring (2..kMaxStages)
  int threads, smem, grid;
  int total_stages;   // ceil(rows / group)
  int dg, du;         // threads / units and threads % units
  int staged, vec, out_is_bf16;
  int bgr;  // channel order: out[c] takes byte 2 - c (caffe), else byte c
  float scale[3];
  float bias[3];
};

namespace {

// A staged row as its producer leaves it for the block.
struct RowState {
  int delta;  // buffer index of the byte at span offset o: o + delta
  int xb;     // blanked output columns of this row
  int sy;     // source row (the mask's row)
  int pad;
};

__device__ __forceinline__ uint64_t min64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// The nearest-neighbour source index of output index i, in float64 as
// ops/image.py::nearest_indices computes it (each operation rounded once,
// so the same index): TF's floor((i + 0.5) * s), cv2's floor(i * s),
// clipped to the source.
__device__ __forceinline__ int src_index(int i, double s, int n_src, int cv2) {
  const double x = cv2 ? static_cast<double>(i)
                       : __dadd_rn(static_cast<double>(i), 0.5);
  return min(static_cast<int>(floor(__dmul_rn(x, s))), n_src - 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrives on `bar` and adds `bytes` to the transfer its phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (TMA, 1-D) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global memory into shared memory, completing on
// `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, uint64_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk store (TMA, 1-D) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from shared memory to global memory, in a bulk group of
// its own.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// Exact float of a byte: 2^23 + v has v in its low mantissa bits.
__device__ __forceinline__ float byte_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Writes the 3 * P values of one unit to o: P whole pixels (48 bytes: 8 in
// bf16, 4 in float32) as three 16-byte stores, or one pixel as three
// scalar stores.
template <int P>
__device__ __forceinline__ void store_unit(float* o, const float* v) {
  if constexpr (P > 1) {
    uint4* q = reinterpret_cast<uint4*>(o);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]),
                        __float_as_uint(v[4 * i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) o[i] = v[i];
  }
}

template <int P>
__device__ __forceinline__ void store_unit(__nv_bfloat16* o, const float* v) {
  if constexpr (P > 1) {
    uint4* q = reinterpret_cast<uint4*>(o);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = make_uint4(bf16x2(v[8 * i], v[8 * i + 1]),
                        bf16x2(v[8 * i + 2], v[8 * i + 3]),
                        bf16x2(v[8 * i + 4], v[8 * i + 5]),
                        bf16x2(v[8 * i + 6], v[8 * i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) o[i] = __float2bfloat16_rn(v[i]);
  }
}

// One unit: output pixels x0 .. x0 + P - 1 of a row whose pixel x0 + q
// has its bytes at row[off[q] ..] (shared memory if STAGED, else global).
// MASKED: the row has blanked columns (x < xb) or a beam mask; else every
// pixel is read and the multiply by m = 1 is left out (exact either way).
// BGR: out[c] takes byte 2 - c, else byte c.
template <typename OutT, int P, bool STAGED, bool MASKED, bool BGR>
__device__ __forceinline__ void unit(const uint8_t* row, int xb,
                                     const float* mrow, int x0,
                                     const int (&off)[P], const Params& p,
                                     OutT* o) {
  float v[3 * P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uint32_t b[3] = {0, 0, 0};
    float m = 1.0f;
    bool read = true;
    if constexpr (MASKED) {
      if (x0 + q < xb) {
        read = false;
        m = 0.0f;
      } else if (mrow != nullptr) {
        m = __ldg(mrow + (off[q] + p.lo) / 3);
      }
    }
    if (read) {
      const uint8_t* px = row + off[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (STAGED)
          b[c] = px[BGR ? 2 - c : c];
        else
          b[c] = __ldg(px + (BGR ? 2 - c : c));
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float t = __fmul_rn(byte_float(b[c]), p.scale[c]);
      if constexpr (MASKED) t = __fmul_rn(t, m);
      v[3 * q + c] = __fadd_rn(t, p.bias[c]);
    }
  }
  store_unit<P>(o, v);
}

// VEC: the output rows are a whole number of 16-byte vectors; a thread
// computes P whole pixels (48 bytes) at a time, the block leaves each
// stage's values in shared memory, in the rows' layout, and one thread
// writes them with one bulk store. Else (P = 1) a thread computes one
// pixel and stores it itself.
// STAGED: source rows staged in shared memory by bulk copies; else
// gathered from global memory. BGR: the channel order (caffe).
//
// The output rows are cut into stages of `group` consecutive rows; block b
// takes stages b, b + gridDim.x, ..., so the blocks on the card at once
// sweep the frames in order, as the memory is laid out.
//
// Shared memory: (STAGED) kMaxStages mbarriers, RowState[stages][group],
// `stages` buffers of `group` row slots; (VEC) two stages of output.
template <typename OutT, int P, bool VEC, bool STAGED, bool BGR>
__global__ void __launch_bounds__(256)
    preprocess_kernel(const uint8_t* __restrict__ src, OutT* __restrict__ out,
                      const float* __restrict__ mask, const Params p) {
  static_assert(VEC || !STAGED,
                "staged buffers are freed at the VEC path's stage barrier");
  extern __shared__ uint4 smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_raw);
  const int S = p.stages, G = p.group;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  RowState* const state = reinterpret_cast<RowState*>(smem + 8 * kMaxStages);
  uint8_t* const stage =
      smem + (STAGED ? 8 * kMaxStages + S * G * static_cast<int>(
                                                    sizeof(RowState))
                     : 0);
  const int tid = threadIdx.x;
  // The output of two stages (VEC), in the rows' own layout.
  OutT* const obuf =
      reinterpret_cast<OutT*>(stage + (STAGED ? S * G * p.slot : 0));
  const int stage_elems = G * p.wd * 3;

  const int n_stages = (p.total_stages - static_cast<int>(blockIdx.x) +
                        static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  // First output row and rows of this block's stage s.
  auto first_row = [&](int s) {
    return static_cast<long long>(blockIdx.x + s * gridDim.x) * G;
  };
  auto rows_in = [&](int s) {
    return static_cast<int>(min(static_cast<long long>(G),
                                p.rows - first_row(s)));
  };

  const uint64_t src_lo = reinterpret_cast<uint64_t>(src);
  const uint64_t src_hi = src_lo + static_cast<uint64_t>(p.src_bytes);
  // Lane g of warp 0 stages row g of stage s into buffer s % S: the 16-byte
  // chunks of its window that lie inside the tensor by one bulk copy, the
  // bytes that the tensor's ends cut from a chunk by plain loads; then it
  // leaves the row's state and arrives on the buffer's barrier (every lane
  // once a stage, with the bytes it copies).
  auto produce = [&](int s) {
    const int buf = s % S, g = tid;
    uint32_t bytes = 0;
    if (g < rows_in(s)) {
      const int r = static_cast<int>(first_row(s)) + g;
      const int b = r / p.hd;
      const int sy = src_index(r - b * p.hd, p.scale_h, p.hs, p.cv2);
      const uint64_t row =
          src_lo + (static_cast<int64_t>(b) * p.hs + sy) *
                       (static_cast<int64_t>(p.ws) * 3);
      const bool blank = sy < p.blank_h;
      const int lo = blank ? p.lo_blank : p.lo;
      const uint64_t w0 = (row + lo) & ~uint64_t(15);
      const uint64_t w1 = lo < p.hi ? (row + p.hi + 15) & ~uint64_t(15) : w0;
      const uint64_t a0 = min64(max64(w0, (src_lo + 15) & ~uint64_t(15)), w1);
      const uint64_t a1 = max64(min64(w1, src_hi & ~uint64_t(15)), a0);
      uint8_t* slot = stage + (buf * G + g) * p.slot;
      for (uint64_t a = max64(w0, src_lo); a < a0; ++a)
        slot[a - w0] = *reinterpret_cast<const uint8_t*>(a);
      for (uint64_t a = a1; a < min64(w1, src_hi); ++a)
        slot[a - w0] = *reinterpret_cast<const uint8_t*>(a);
      state[buf * G + g] =
          RowState{static_cast<int>(row + p.lo - w0), blank ? p.xb : 0, sy, 0};
      bytes = static_cast<uint32_t>(a1 - a0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive_tx(&full[buf], bytes);
      if (bytes > 0) bulk_copy(slot + (a0 - w0), a0, bytes, &full[buf]);
    } else {
      bar_arrive_tx(&full[buf], 0);
    }
  };

  if constexpr (STAGED) {
    if (tid == 0) {
      for (int i = 0; i < S; ++i) bar_init(&full[i], 32);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid < 32)
      for (int s = 0; s < S - 1 && s < n_stages; ++s) produce(s);
  }

  // This thread's first unit (row g0, unit u0 of the stage) and its step.
  // Column offsets are computed, not read: where the step keeps the unit
  // (du == 0) they are computed once and stay in registers for the block.
  const int units = p.wd / P;
  const int g0 = tid / units, u0 = tid - g0 * units;
  const int dg = p.dg, du = p.du;
  // Byte offset of output column x's pixel from the span start lo.
  auto col = [&](int x) {
    return 3 * src_index(x, p.scale_w, p.ws, p.cv2) - p.lo;
  };
  int off0[P];
#pragma unroll
  for (int q = 0; q < P; ++q) off0[q] = col(u0 * P + q);
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s % S;
    if constexpr (STAGED) {
      if (tid < 32 && s + S - 1 < n_stages) produce(s + S - 1);
      bar_wait(&full[buf], (s / S) & 1);
    }
    const int rs = static_cast<int>(first_row(s));
    const int items = rows_in(s) * units;
    // Unit i of the stage is output element (rs * wd + i * P) * 3.
    for (int i = tid, g = g0, u = u0; i < items; i += blockDim.x) {
      const int r = rs + g;
      const uint8_t* row;
      int xb, sy;
      if constexpr (STAGED) {
        const RowState st = state[buf * G + g];
        row = stage + (buf * G + g) * p.slot + st.delta;
        xb = st.xb;
        sy = st.sy;
      } else {
        const int b = r / p.hd;
        sy = src_index(r - b * p.hd, p.scale_h, p.hs, p.cv2);
        row = src + (static_cast<int64_t>(b) * p.hs + sy) *
                        (static_cast<int64_t>(p.ws) * 3) +
              p.lo;
        xb = sy < p.blank_h ? p.xb : 0;
      }
      const float* mrow =
          mask == nullptr ? nullptr : mask + static_cast<int64_t>(sy) * p.ws;
      OutT* o = VEC ? obuf + (s & 1) * stage_elems + i * 3 * P
                    : out + (static_cast<int64_t>(r) * p.wd + u * P) * 3;
      const bool masked = mrow != nullptr || xb > u * P;
      int off[P];
#pragma unroll
      for (int q = 0; q < P; ++q) off[q] = du == 0 ? off0[q] : col(u * P + q);
      if (masked)
        unit<OutT, P, STAGED, true, BGR>(row, xb, mrow, u * P, off, p, o);
      else
        unit<OutT, P, STAGED, false, BGR>(row, xb, mrow, u * P, off, p, o);
      g += dg;
      u += du;
      if (u >= units) {
        u -= units;
        ++g;
      }
    }
    if constexpr (VEC) {
      // The stage's values are in obuf and its staged rows have been read.
      // One bulk store of the stage's rows, contiguous in the output; once
      // the previous stage's store has read its buffer, that buffer is free
      // for the next stage.
      __syncthreads();
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(out + static_cast<int64_t>(rs) * p.wd * 3,
                   obuf + (s & 1) * stage_elems,
                   static_cast<uint32_t>(items * P * 3 * sizeof(OutT)));
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      }
      __syncthreads();
    }
  }
  // The bulk stores have read shared memory before the block leaves it
  // (the grid's completion makes their writes visible).
  if (VEC && tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Calls f.run<OutT, P, VEC, STAGED, BGR>() for the instance that `p`
// selects: 48-byte units (VEC), staged or gathered, or the scalar branch
// (P = 1, gathered).
template <typename OutT, int P, bool VEC, bool STAGED, typename F>
int dispatch_bgr(const Params& p, const F& f) {
  return p.bgr ? f.template run<OutT, P, VEC, STAGED, true>()
               : f.template run<OutT, P, VEC, STAGED, false>();
}

template <typename OutT, int P, bool VEC, typename F>
int dispatch_staged(const Params& p, const F& f) {
  return p.staged ? dispatch_bgr<OutT, P, VEC, true>(p, f)
                  : dispatch_bgr<OutT, P, VEC, false>(p, f);
}

template <typename OutT, typename F>
int dispatch_vec(const Params& p, const F& f) {
  constexpr int kWide = 48 / (3 * static_cast<int>(sizeof(OutT)));
  return p.vec ? dispatch_staged<OutT, kWide, true>(p, f)
               : dispatch_bgr<OutT, 1, false, false>(p, f);
}

template <typename F>
int dispatch(const Params& p, const F& f) {
  return p.out_is_bf16 ? dispatch_vec<__nv_bfloat16>(p, f)
                       : dispatch_vec<float>(p, f);
}

struct Launch {
  const uint8_t* src;
  void* out;
  const float* mask;
  const Params& p;
  cudaStream_t stream;
  template <typename OutT, int P, bool VEC, bool STAGED, bool BGR>
  int run() const {
    preprocess_kernel<OutT, P, VEC, STAGED, BGR>
        <<<p.grid, p.threads, p.smem, stream>>>(src, static_cast<OutT*>(out),
                                                mask, p);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  const Params& p;
  template <typename OutT, int P, bool VEC, bool STAGED, bool BGR>
  int run() const {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, preprocess_kernel<OutT, P, VEC, STAGED, BGR>, p.threads,
            p.smem) !=
        cudaSuccess)
      return -1;
    return n;
  }
};

}  // namespace

extern "C" {

// Launches the kernel on `stream` with the plan `p` (ops/preprocess_cuda.py
// ::launch_plan) and returns cudaGetLastError() (0 on success). `mask` is a
// float32 [hs, ws] 0/1 beam mask or null.
int ablc_preprocess(const void* src, void* out, const void* mask,
                    const Params* p, void* stream) {
  if (p->rows <= 0) return 0;
  return dispatch(*p, Launch{static_cast<const uint8_t*>(src), out,
                             static_cast<const float*>(mask), *p,
                             static_cast<cudaStream_t>(stream)});
}

// Blocks of the instance that `p` selects, at p->threads and p->smem, that
// fit on one SM at once (registers included), or -1 on error.
int ablc_preprocess_blocks_per_sm(const Params* p) {
  return dispatch(*p, Occupancy{*p});
}

const char* ablc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
