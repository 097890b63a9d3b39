// K1: fused uint8 clip preprocess for Hopper (sm_90a), a streaming kernel.
//
// Replaces the TPU kernel `_preprocess_kernel` (ted_spad_tpu/ops/pallas_preprocess.py:62,
// launched by `fused_preprocess`). Both compute, per frame and channel,
//     out = R_y @ img @ R_x^T      (f32 accumulation)
// where R_y (out_h, H) and R_x (out_w, W) come from `resize_matrix`: crop window,
// antialiased triangle filter, 1/255 folded into R_y. Input (N, H, W, 3) uint8;
// output (N, out_h, out_w, 3) bf16 or f32, channels interleaved, which is an NCHW
// tensor in channels_last format for the anonymizer's first convolution.
//
// Crops. The TPU kernel baked in the centre crop; the JAX stage sent its other crops
// (torchvision's five and ten crops, the square window of no_ar_distortion) through
// XLA. Here one launch serves up to kMaxCrops windows of one size: the tables are
// planned for the first window, and a window of the same size at another place has
// the same matrices shifted by its offset (dy, dx), so a crop only moves the rows and
// columns a block stages. A mirrored crop (the ten-crop's flipped five) reverses each
// run in registers and stores it at output column out_w - 1 - x: no flip pass, and
// the band tables keep their rising starts. The crop is the grid's y index and its
// offsets are read by that index from the parameters; the mirrored store lives in its
// own instantiation (MIRROR), launched only when a crop is mirrored. Measured (PERF.md,
// section 6): a first form with the mirror compiled into every kernel and the crop
// decoded from blockIdx.x cost the centre crop 21% of its time; this one is within 1%
// of the kernel without crops at the serving frame, 2% slower at 480x856 and 1080p.
// Output frame (clip, crop, t) of (clips, n_crops, clip_frames, out_h, out_w, 3): the
// crop axis sits before time.
//
// Bound. At the serving shape (16 clips x 16 frames of 240x320x3 uint8 -> 224x224x3
// bf16) the function must read the 0.8 crop window, 192x256x3 bytes per frame
// (37,748,736 B), and write 77,070,336 B: 34.3 us at 3.35 TB/s. The banded arithmetic
// is ~0.35 GFLOP (~5 us at the 67 TFLOP/s f32 CUDA-core rate): bytes bound it. The
// TPU kernel multiplied the dense matrices on its matrix unit; this kernel never
// touches their zeros beyond one run's span.
//
// Design. The host (ops/preprocess.py:k1_plan) turns R_y into a band per output row
// (first input row, KY weights) and R_x into one dense (SPAN x RUN) weight tile per
// run of RUN = 8 consecutive output pixels, over the SPAN input columns the run
// touches; both are zero-padded up to a compile-time (KY, SPAN) from K1_CASE below,
// so every tap loop unrolls. The table holds three pairs, each measured faster than
// the runtime-taps kernel at the frames that take it (PERF.md, section 6): <2, 12>
// for the serving frame (2 rows, 11 columns), <4, 32> for 480x856 and 360x640, <8, 64>
// for 720p and 1080p.
// - A block owns one band of output rows of one frame (32 rows at the serving shape:
//   1,792 blocks, 37,200 B of shared memory each). It stages the band's input rows,
//   only the crop window's columns, with 16-byte cp.async, together with the tables,
//   then computes. Loads overlap arithmetic across blocks: k1_plan picks the largest
//   band that lets three blocks of 8 warps share an SM (shared memory with each
//   block's 1 KB reservation, and registers: <2, 12>, <4, 32> and the runtime kernel
//   need at most 80 a thread), else the largest band that fits one (<8, 64>, at 87
//   registers, is always planned so). At the serving shape four blocks fit (64
//   registers), with up to 93 KB of row copies in flight per SM. Launch bounds that
//   ask for three blocks were measured: they push every instantiation to 80 registers
//   and <8, 64> into spills, 11% slower at 1080p. A
//   two-stage ring over persistent blocks was built and measured first: no faster at
//   the serving shape and slower where one block fills an SM, so it went.
// - A thread owns one run: for each group of 4 input columns it reads 4-byte words of
//   the staged uint8 rows, aligns them with a funnel shift, turns bytes into floats
//   with a byte permute and one add, sums the KY rows (vertical pass), then adds the
//   group's columns into its 8x3 outputs with the run's weights (horizontal pass),
//   all in registers: no intermediate tile. The order is the plain version's,
//   (R_y @ img) @ R_x^T.
// - The outputs of a run leave as three 16-byte stores (bf16) or six (f32).
// - The padded tables of a compile-time instantiation sit in shared memory (14 KB at
//   the serving shape, 58 KB at SPAN 64); no division remains in the inner loops.
//
// Unaligned shapes. A staged row is the 16-byte-aligned superset of its window bytes,
// shifted by the row's own (address & 15); reads add that shift. Chunks that would
// cross the tensor's first or last byte (an unaligned base pointer, the last row)
// are copied byte by byte, so no byte outside the tensor is read. Any row pitch and
// any base alignment take this path; only the two ends pay for it.
// Large tap counts. Shapes past the table (more than 8 rows or 64 columns per run)
// take the runtime-taps instantiation <0, 0>: the same code with loop bounds read at
// run time and the tables read from device memory (L1/L2), so only the input rows take
// shared memory; bands shrink as the plan needs, down to one output row per block.
//
// Left to a later PR: a horizontal pass that skips each output's zero columns (the
// dense tile costs SPAN x RUN FMAs per channel where KX x RUN would do: 4x at the
// serving shape), TMA (cp.async.bulk) loads and stores, and the YUV420 variant.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;  // output pixels per thread (ops/preprocess.py: K1_RUN)
constexpr int kMaxCrops = 16;  // windows of one launch (ops/preprocess.py: K1_MAX_CROPS)

struct Params {
  const uint8_t* in;
  unsigned long long in_bytes;  // the tensor's extent: no byte outside it is read
  void* out;
  const float* tables;  // words: wrun | vw | xs (int) | vstart (int), each 16-byte aligned
  int table_words, wrun_off, vw_off, xs_off, vstart_off;
  int ky, span;  // taps as padded by the plan (the template's, unless it is <0, 0>)
  int n_frames, h, w, col0, n_cols, out_h, out_w, runs;
  int band_rows, n_bands, rows_buf, row_pitch;
  int n_crops, clip_frames;  // crops per frame; frames per clip of the output layout
  int crop_dy[kMaxCrops], crop_dx[kMaxCrops];  // each crop's offset from the planned window
  unsigned mirror_mask;  // bit c: crop c is mirrored
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Byte i of w as a float: 0x4B0000bb is 2^23 + bb exactly.
__device__ __forceinline__ float u8f(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B00u, 0x5440u | i)) - 8388608.f;
}

__device__ __forceinline__ uint32_t bf2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_run(float* dst, const float* v, int n) {
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < kRun * 3 / 4; ++i)
      d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {  // constant indices keep v in registers
#pragma unroll
    for (int i = 0; i < kRun * 3; ++i)
      if (i < n * 3) dst[i] = v[i];
  }
}
__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float* v, int n) {
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < kRun * 3 / 8; ++i)
      d[i] = make_uint4(bf2(v[8 * i], v[8 * i + 1]), bf2(v[8 * i + 2], v[8 * i + 3]),
                        bf2(v[8 * i + 4], v[8 * i + 5]), bf2(v[8 * i + 6], v[8 * i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < kRun * 3; ++i)
      if (i < n * 3) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

// A run of n outputs mirrored: v's pixel q goes to dst pixel n - 1 - q, where dst is the
// run's first pixel in the mirrored row. Constant indices into v keep it in registers.
template <typename OutT>
__device__ __forceinline__ void store_run_mirrored(OutT* dst, const float* v, int n) {
  if (n == kRun) {
    float r[kRun * 3];
#pragma unroll
    for (int q = 0; q < kRun; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) r[q * 3 + c] = v[(kRun - 1 - q) * 3 + c];
    store_run(dst, r, kRun);
  } else {
#pragma unroll
    for (int q = 0; q < kRun; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (q < n) dst[(n - 1 - q) * 3 + c] = to_out(v[q * 3 + c], dst);
  }
}

// KY > 0: compile-time taps (KY rows, SPAN columns per run), tables in shared memory.
// KY == 0: runtime taps (p.ky, p.span), tables read from device memory.
// MIRROR: the crops of p.mirror_mask are stored mirrored.
template <typename OutT, int KY, int SPAN, bool MIRROR>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStatic = KY > 0;
  const int ky = kStatic ? KY : p.ky;
  const int groups = (kStatic ? SPAN : p.span) / 4;
  const int rstride = (kStatic ? SPAN : p.span) * kRun + 4;  // words per run's weight tile
  const int w3 = p.w * 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uintptr_t in_lo = reinterpret_cast<uintptr_t>(p.in);
  const uintptr_t in_hi = in_lo + p.in_bytes;

  // This block's work item: one band of output rows of one frame (x), one crop (y).
  const int frame = blockIdx.x / p.n_bands;
  const int oy0 = (blockIdx.x - frame * p.n_bands) * p.band_rows;
  const int n_out = min(p.band_rows, p.out_h - oy0);
  const int crop = blockIdx.y;
  const int dy = p.crop_dy[crop], dx = p.crop_dx[crop];
  const bool mirror = MIRROR && ((p.mirror_mask >> crop) & 1u);
  const int* vstart_g = reinterpret_cast<const int*>(p.tables + p.vstart_off);
  const int v0 = __ldg(vstart_g + oy0);  // the band's first row in the planned window
  const int r0 = v0 + dy;
  const int n_in = min(__ldg(vstart_g + oy0 + n_out - 1) + ky + dy, p.h) - r0;
  const uintptr_t first = in_lo + (static_cast<size_t>(frame) * p.h + r0) * w3 +
                          static_cast<size_t>(p.col0 + dx) * 3;

  // 1. Copies, all in flight together: the tables (compile-time taps only) and the
  //    band's input rows, window columns only, each row as the 16-byte-aligned
  //    superset of its bytes. Chunks that would cross the tensor's first or last
  //    byte are copied byte by byte, reading nothing outside the tensor.
  const float* tab = p.tables;
  unsigned char* rows = smem;
  if constexpr (kStatic) {
    for (int i = threadIdx.x; i < p.table_words / 4; i += kThreads)
      cp_async16(smem_addr(smem + 16 * i), p.tables + 4 * i);
    tab = reinterpret_cast<const float*>(smem);
    rows = smem + static_cast<size_t>(p.table_words) * 4;
  }
  const int chunks = (15 + p.n_cols * 3 + 15) / 16;
  for (int r = warp; r < n_in; r += kWarps) {
    const uintptr_t a0 = (first + static_cast<size_t>(r) * w3) & ~static_cast<uintptr_t>(15);
    unsigned char* d = rows + r * p.row_pitch;
    for (int c = lane; c < chunks; c += 32) {
      const uintptr_t a = a0 + 16 * c;
      if (a >= in_lo && a + 16 <= in_hi) {
        cp_async16(smem_addr(d + 16 * c), reinterpret_cast<const void*>(a));
      } else {
        for (int b = 0; b < 16; ++b)
          d[16 * c + b] = (a + b >= in_lo && a + b < in_hi)
                              ? __ldg(reinterpret_cast<const uint8_t*>(a + b)) : 0;
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // 2. Every run of the band: vertical then horizontal in registers, then stored.
  const float* wrun = tab + p.wrun_off;
  const float* vw = tab + p.vw_off;
  const int* xs = reinterpret_cast<const int*>(tab + p.xs_off);
  const int* vstart = reinterpret_cast<const int*>(tab + p.vstart_off);
  const uint32_t first_lo = static_cast<uint32_t>(first);
  const int clip = frame / p.clip_frames;
  const size_t out_frame = (static_cast<size_t>(clip) * p.n_crops + crop) * p.clip_frames +
                           (frame - clip * p.clip_frames);
  OutT* out = static_cast<OutT*>(p.out) + (out_frame * p.out_h + oy0) * p.out_w * 3;
  for (int u = threadIdx.x; u < n_out * p.runs; u += kThreads) {
    const int ty = u / p.runs, run = u - ty * p.runs;
    const int vs = vstart[oy0 + ty] - v0;
    const float* wy = vw + (oy0 + ty) * ky;
    const float* wr = wrun + run * rstride;
    const uint32_t x3 = 3u * xs[run];
    float acc[kRun * 3];
#pragma unroll
    for (int i = 0; i < kRun * 3; ++i) acc[i] = 0.f;
#pragma unroll
    for (int g = 0; g < groups; ++g) {
      float v[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) v[i] = 0.f;
      // Vertical pass: 4 columns x 3 channels, summed over the ky rows. A staged row
      // starts at its source address & 15; 4-byte words realigned by a funnel shift.
#pragma unroll
      for (int k = 0; k < ky; ++k) {
        const int rr = vs + k;
        const uint32_t off = ((first_lo + static_cast<uint32_t>(rr) * w3) & 15u) + x3;
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(rows + rr * p.row_pitch + (off & ~3u)) + 3 * g;
        const uint32_t sh = (off & 3u) * 8;
        const uint32_t w0 = wp[0], w1 = wp[1], w2 = wp[2], w3w = wp[3];
        const uint32_t a[3] = {__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                               __funnelshift_r(w2, w3w, sh)};
        const float wk = wy[k];
#pragma unroll
        for (int i = 0; i < 12; ++i) v[i] = fmaf(wk, u8f(a[i / 4], i % 4), v[i]);
      }
      // Horizontal pass: each of the 4 columns into the run's 8 outputs.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* wj = reinterpret_cast<const float4*>(wr + (4 * g + jj) * kRun);
        const float4 lo = wj[0], hi = wj[1];
        const float wx[kRun] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int q = 0; q < kRun; ++q)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[q * 3 + c] = fmaf(wx[q], v[jj * 3 + c], acc[q * 3 + c]);
      }
    }
    const int n = min(kRun, p.out_w - run * kRun);
    if (mirror)
      store_run_mirrored(out + (static_cast<size_t>(ty) * p.out_w + p.out_w - run * kRun - n) * 3,
                         acc, n);
    else
      store_run(out + (static_cast<size_t>(ty) * p.out_w + run * kRun) * 3, acc, n);
  }
}

template <typename OutT, int KY, int SPAN>
int launch(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = p.mirror_mask ? preprocess_kernel<OutT, KY, SPAN, true>
                              : preprocess_kernel<OutT, KY, SPAN, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.n_frames * p.n_bands, p.n_crops), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The compile-time instantiations: ops/preprocess.py's K1_TAPS mirrors this table
// (tests/test_torch_port_preprocess_plan.py checks it).
template <typename OutT>
int dispatch(const Params& p, bool is_static, int smem, cudaStream_t s) {
  if (!is_static) return launch<OutT, 0, 0>(p, smem, s);
#define K1_CASE(KY, SPAN) \
  if (p.ky == KY && p.span == SPAN) return launch<OutT, KY, SPAN>(p, smem, s);
  K1_CASE(2, 12) K1_CASE(4, 32) K1_CASE(8, 64)
#undef K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes). `in` is (n_frames, h, w, 3) uint8 spanning
// in_bytes; `out` is (n_frames / clip_frames, n_crops, clip_frames, out_h, out_w, 3)
// float32 (out_bf16 == 0) or bfloat16. `tables` and the geometry come from
// ops/preprocess.py:k1_plan for the first crop's window, `smem` is the plan's shared
// bytes; `crops` holds (dy, dx, mirror) per crop, host memory read here. One block per
// (frame and band, crop). Returns the cudaError_t of the launch.
extern "C" int ted_preprocess_u8(const uint8_t* in, long long in_bytes, void* out, int out_bf16,
                                 const float* tables, int table_words, int wrun_off, int vw_off,
                                 int xs_off, int vstart_off, int ky, int span, int is_static,
                                 int n_frames, int h, int w, int col0, int n_cols, int out_h,
                                 int out_w, int runs, int band_rows, int rows_buf, int row_pitch,
                                 int smem, void* stream, const int* crops, int n_crops,
                                 int clip_frames) {
  if (n_crops < 1 || n_crops > kMaxCrops || clip_frames < 1 || n_frames % clip_frames != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{in, static_cast<unsigned long long>(in_bytes), out, tables, table_words, wrun_off,
           vw_off, xs_off, vstart_off, ky, span, n_frames, h, w, col0, n_cols, out_h, out_w,
           runs, band_rows, (out_h + band_rows - 1) / band_rows, rows_buf, row_pitch,
           n_crops, clip_frames, {}, {}, 0u};
  for (int c = 0; c < n_crops; ++c) {
    p.crop_dy[c] = crops[3 * c];
    p.crop_dx[c] = crops[3 * c + 1];
    if (crops[3 * c + 2]) p.mirror_mask |= 1u << c;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<__nv_bfloat16>(p, is_static, smem, s)
                  : dispatch<float>(p, is_static, smem, s);
}
