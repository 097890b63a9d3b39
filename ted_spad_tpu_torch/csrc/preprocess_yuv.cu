// K3: fused YUV420 planar preprocess for Hopper (sm_90a), a streaming kernel.
//
// Replaces the JAX package's `fused_preprocess_yuv` (ted_spad_tpu/ops/yuv.py:42), an
// XLA einsum chain with no Pallas kernel: in PyTorch that chain would write float32
// intermediates several times the size of the bytes the YUV mode exists to save (1.5
// bytes per pixel shipped to the card instead of RGB24's 3). Per frame it computes
//     Y' = R_y  @ Y @ R_x^T                (the 0.8 crop window, antialiased resample)
//     U' = cR_y @ U @ cR_x^T - 128,  V' likewise
// where (cR_y, cR_x) resample the half-resolution chroma planes straight to the output
// grid (which absorbs the 2x chroma upsample), then the affine YCbCr -> RGB of the clip's
// colour set (BT.601 / BT.709 x limited / full range, chosen by the clip's tag byte),
// /255, the clip to [0, 1], and a bf16 or f32 store in K1's output layout
// (frames, out_h, out_w, 3), channels interleaved.
// Input: the packed row of the YUV decode mode, (frames, L) uint8 with
// L = H*W + 2*(H/2)*(W/2) [+ 1 tag byte]: [Y | U | V | tag], read in place by plane
// offsets (no host-side split copy). The tag byte of a clip's first frame holds bit 0 =
// BT.709, bit 1 = full range; without it every clip is BT.601 limited range.
//
// Bound. At the serving shape (16 clips x 16 frames of 240x320 -> 224x224 bf16) the
// function must read the windows, 192x256 luma and 2 x 96x128 chroma bytes per frame
// (18,874,368 B), and write 77,070,336 B: 28.7 us at 3.35 TB/s. The banded arithmetic is
// under 0.3 GFLOP: bytes bound it.
//
// Design: K1's streaming design (csrc/preprocess.cu) over three planes, each step kept
// only where the card timed it faster (PERF.md, section 6).
// - The host (ops/yuv.py:k3_plan) turns each plane's matrices into banded tables: per
//   output row its first input row and KY weights, per run of 8 outputs its first column
//   and a dense SPAN x 8 weight tile (padded by 4 words, so that neighbouring runs' tiles
//   lie on other banks), zero-padded to a compile-time (KY, SPAN, KYC, SPANC) from
//   K3_CASE below, so that every tap loop unrolls. The row tables are laid out per band.
// - A block owns one band of output rows of one frame. In one cp.async group it stages
//   the run tables, its band's row tables (compile-time taps only: the runtime-taps
//   instantiation <0, 0, 0, 0> reads them through L1) and the band's window rows of Y,
//   U and V (each row the 16-byte-aligned superset of its bytes; chunks that would
//   cross the tensor's ends byte by byte), then computes.
// - A warp takes a tile of 8 output rows x 4 runs (ops/yuv.py: K3_WARP_ROWS); a thread
//   one run of one row: Y, then U and V together (one pass over the chroma tables), 4
//   input columns at a time. Vertical pass: each staged row's 4 bytes are two aligned
//   words and a funnel shift, turned into floats by a byte permute and one subtract,
//   summed over KY rows whose offsets are computed once per run; horizontal pass: the 4
//   columns into the run's 8 outputs. The colour transform follows in registers, with
//   the /255 folded into its coefficients and __fmul_rn / __fadd_rn in the plain
//   version's order, and the run leaves as three 16-byte stores (bf16). The tile cursor
//   divides nothing. On an NVIDIA H100 80GB HBM3 at 700 W, a warp on one run over 32
//   rows (the first form) wrote each store to 32 lines: 0.0990 ms at the serving batch
//   against 0.0681 for the 8 x 4 tile.
// - Measured there and dropped: 64-row bands; staging the outputs in shared memory per
//   warp or per band, for 512-byte contiguous stores (constants stored so take 0.0408 ms
//   against 0.0744 in the kernel's own pattern, but the staged kernels ran 0.080–0.088: a
//   store phase with no arithmetic beside it, and 80 registers with spills); streaming
//   stores; persistent blocks that stage the run tables once.
// Left to a later PR: a horizontal pass that skips each run's zero columns (the dense
// tile costs SPAN x 8 FMAs per plane where KX x 8 would do), and TMA loads and stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;  // output pixels per thread (ops/yuv.py: K1_RUN)
constexpr int kTilePad = 4;  // words after each run's weight tile (ops/yuv.py: K3_TILE_PAD)

// (ky, y_off, rv, gu, gv, bu) of BT.601 limited, BT.709 limited, BT.601 full, BT.709 full
// (ops/yuv.py: COLOR_SETS), indexed by bt709 + 2 * full, with the /255 folded into every
// coefficient but y_off, so the store divides nothing.
#define K3_SET(ky, y_off, rv, gu, gv, bu) \
  {ky / 255.f, y_off, rv / 255.f, gu / 255.f, gv / 255.f, bu / 255.f}
__constant__ float kColor[4][6] = {
    K3_SET(1.164383f, 16.0f, 1.596027f, -0.391762f, -0.812968f, 2.017232f),
    K3_SET(1.164383f, 16.0f, 1.792741f, -0.213249f, -0.532909f, 2.112402f),
    K3_SET(1.0f, 0.0f, 1.402f, -0.344136f, -0.714136f, 1.772f),
    K3_SET(1.0f, 0.0f, 1.5748f, -0.187324f, -0.468124f, 1.8556f),
};
#undef K3_SET

// One plane's tables and staging geometry, as ops/yuv.py:k3_plan lays them out.
struct Plane {
  long long offset;  // byte offset of the plane in a frame's packed row
  int h, w;          // plane rows and columns
  int col0, n_cols;  // window columns the plane's matrices read
  int ky, span;      // taps as padded by the plan
  int rows_buf, pitch;  // staged rows per band and bytes per staged row
  int xs, wrun;      // word offsets of the run tables in the shared segment
  int vstart, vw;    // word offsets of the row tables in a band's segment
};

struct Params {
  const uint8_t* in;
  unsigned long long in_bytes;
  void* out;
  const float* tables;  // the shared segment, then one segment per band
  int shared_words, band_words;
  long long row_len;  // L: bytes per frame's packed row
  int has_tag, clip_frames;
  int n_frames, out_h, out_w, runs, band_rows, n_bands;
  int warp_rows;  // a warp's tile: warp_rows output rows x 32 / warp_rows runs
  Plane plane[2];  // luma, chroma (U and V share the chroma tables)
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

// Byte i of w as a float: 0x4B0000bb is 2^23 + bb exactly (csrc/preprocess.cu).
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
  } else {
#pragma unroll
    for (int i = 0; i < kRun * 3; ++i)
      if (i < n * 3) dst[i] = v[i];
  }
}
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

// Copy `words` (a multiple of 4) table words into shared memory, all threads.
__device__ __forceinline__ void stage_words(float* dst, const float* src, int words) {
  for (int i = threadIdx.x; i < words / 4; i += kThreads)
    cp_async16(smem_addr(dst + 4 * i), src + 4 * i);
}

// Stage rows [r0, r0 + n_in) of a plane (window columns) into `rows`, each row the
// 16-byte-aligned superset of its bytes; the reader recomputes each row's
// (address & 15). Chunks that would cross the tensor's ends go byte by byte.
__device__ __forceinline__ void stage_plane(unsigned char* rows, uintptr_t first, int n_in,
                                            int row_bytes, int n_cols, int pitch,
                                            uintptr_t in_lo, uintptr_t in_hi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (15 + n_cols + 15) / 16;
  for (int r = warp; r < n_in; r += kWarps) {
    const uintptr_t a0 = (first + static_cast<size_t>(r) * row_bytes) & ~static_cast<uintptr_t>(15);
    unsigned char* d = rows + r * pitch;
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
}

// One staged plane as a run reads it: the rows' base and the low bits of the first
// staged row's source address (a staged row starts at its source address & 15).
struct Staged {
  const unsigned char* rows;
  uint32_t first_lo;
};

// Byte offset, in a staged plane, of window column x of staged row rr.
__device__ __forceinline__ int row_offset(const Staged& s, int rr, int row_bytes, int pitch, int x) {
  return rr * pitch + static_cast<int>((s.first_lo + static_cast<uint32_t>(rr) * row_bytes) & 15u) + x;
}

// The 4 bytes at byte offset `off` of a staged plane: two aligned words and a funnel shift.
__device__ __forceinline__ uint32_t word_at(const unsigned char* rows, int off) {
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(rows + (off & ~3));
  return __funnelshift_r(wp[0], wp[1], (off & 3) * 8);
}

// One run's resample over NP planes that share their tables (Y alone, or U and V):
// acc[p][q] += sum over the run's SPAN columns j of
//     (sum over the KY staged rows k of wy[k] * rows_p[vs + k][x + j]) * wr[j][q]
// (vertical pass, then horizontal pass, in registers; the plain version's order),
// 4 columns at a time: each row's 4 bytes are one realigned word, turned into floats by
// a byte permute and one subtract. KY > 0: compile-time taps, the staged rows' offsets
// computed once per run; KY == 0: runtime taps (ky_rt, span_rt).
template <int NP, int KY, int SPAN>
__device__ __forceinline__ void resample_run(float (&acc)[NP][kRun], const Staged (&st)[NP],
                                             int row_bytes, int pitch, int vs,
                                             const float* __restrict__ wy, int x,
                                             const float* __restrict__ wr, int ky_rt, int span_rt) {
  if constexpr (KY > 0) {
    int off[NP][KY];
    float wk[KY];
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      wk[k] = wy[k];
#pragma unroll
      for (int p = 0; p < NP; ++p) off[p][k] = row_offset(st[p], vs + k, row_bytes, pitch, x);
    }
#pragma unroll
    for (int g = 0; g < SPAN / 4; ++g) {
      float v[NP][4] = {};
#pragma unroll
      for (int k = 0; k < KY; ++k)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t a = word_at(st[p].rows, off[p][k] + 4 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[p][i] = fmaf(wk[k], u8f(a, i), v[p][i]);
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* wj = reinterpret_cast<const float4*>(wr + (4 * g + jj) * kRun);
        const float4 lo = wj[0], hi = wj[1];
        const float wx[kRun] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int q = 0; q < kRun; ++q) acc[p][q] = fmaf(wx[q], v[p][jj], acc[p][q]);
      }
    }
  } else {
    for (int g = 0; g < span_rt / 4; ++g) {
      float v[NP][4] = {};
      for (int k = 0; k < ky_rt; ++k) {
        const float w = __ldg(wy + k);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t a = word_at(st[p].rows, row_offset(st[p], vs + k, row_bytes, pitch, x) + 4 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[p][i] = fmaf(w, u8f(a, i), v[p][i]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* wj = reinterpret_cast<const float4*>(wr + (4 * g + jj) * kRun);
        const float4 lo = __ldg(wj), hi = __ldg(wj + 1);
        const float wx[kRun] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int q = 0; q < kRun; ++q) acc[p][q] = fmaf(wx[q], v[p][jj], acc[p][q]);
      }
    }
  }
}

template <typename OutT, int KY, int SPAN, int KYC, int SPANC>
__global__ void __launch_bounds__(kThreads) preprocess_yuv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStatic = KY > 0;
  const uintptr_t in_lo = reinterpret_cast<uintptr_t>(p.in);
  const uintptr_t in_hi = in_lo + p.in_bytes;
  const int frame = blockIdx.x / p.n_bands;
  const int band = blockIdx.x - frame * p.n_bands;
  const int oy0 = band * p.band_rows;
  const int n_out = min(p.band_rows, p.out_h - oy0);
  const uintptr_t frame_base = in_lo + static_cast<size_t>(frame) * p.row_len;
  const float* band_g = p.tables + p.shared_words + static_cast<size_t>(band) * p.band_words;

  // 1. Copies, all in flight together: the tables (compile-time taps only: the shared
  //    segment and this band's) and the band's rows of Y, U and V (window columns).
  const float* shared_t = p.tables;
  const float* band_t = band_g;
  unsigned char* cursor = smem;
  if constexpr (kStatic) {
    float* t = reinterpret_cast<float*>(smem);
    stage_words(t, p.tables, p.shared_words);
    stage_words(t + p.shared_words, band_g, p.band_words);
    shared_t = t;
    band_t = t + p.shared_words;
    cursor += 4 * (p.shared_words + p.band_words);
  }
  Staged st[3];
  int v0[2];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const Plane& pl = p.plane[q == 0 ? 0 : 1];
    const int* vstart = reinterpret_cast<const int*>(band_g + pl.vstart);
    const int r0 = __ldg(vstart);
    const int n_in = min(__ldg(vstart + n_out - 1) + pl.ky, pl.h) - r0;
    const long long plane_off = pl.offset + (q == 2 ? static_cast<long long>(pl.h) * pl.w : 0);
    const uintptr_t first = frame_base + plane_off + static_cast<size_t>(r0) * pl.w + pl.col0;
    stage_plane(cursor, first, n_in, pl.w, pl.n_cols, pl.pitch, in_lo, in_hi);
    st[q] = Staged{cursor, static_cast<uint32_t>(first)};
    cursor += pl.rows_buf * pl.pitch;
    if (q < 2) v0[q] = r0;
  }
  cp_async_commit();

  // The clip's colour set from its first frame's tag byte, while the copies fly.
  int set = 0;
  if (p.has_tag) {
    const int clip = frame / p.clip_frames;
    const uint8_t tag = __ldg(p.in + (static_cast<size_t>(clip) * p.clip_frames + 1) * p.row_len - 1);
    set = (tag & 1) + 2 * ((tag >> 1) & 1);
  }
  const float cy = kColor[set][0], yoff = kColor[set][1], rv = kColor[set][2];
  const float gu = kColor[set][3], gv = kColor[set][4], bu = kColor[set][5];

  cp_async_wait_all();
  __syncthreads();

  // 2. Every run of the band: Y, then U and V together (one pass over the chroma
  //    tables), resampled in registers, converted, stored. A warp takes a tile of
  //    warp_rows consecutive output rows x 32 / warp_rows consecutive runs; its threads
  //    read that many weight tiles (neighbouring tiles lie on other banks). The tile
  //    cursor (row tile, run tile) steps without a division.
  const Plane& L = p.plane[0];
  const Plane& C = p.plane[1];
  const int* xs_l = reinterpret_cast<const int*>(shared_t + L.xs);
  const int* xs_c = reinterpret_cast<const int*>(shared_t + C.xs);
  const int* vs_l = reinterpret_cast<const int*>(band_t + L.vstart);
  const int* vs_c = reinterpret_cast<const int*>(band_t + C.vstart);
  const int span_l = kStatic ? SPAN : L.span, span_c = kStatic ? SPANC : C.span;
  const int ky_l = kStatic ? KY : L.ky, ky_c = kStatic ? KYC : C.ky;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_t = p.warp_rows, runs_t = 32 / rows_t;
  const int n_rt = (n_out + rows_t - 1) / rows_t;
  const int d_ct = kWarps / n_rt, d_rt = kWarps - d_ct * n_rt;
  int ct = warp / n_rt, rt = warp - ct * n_rt;
  OutT* out = static_cast<OutT*>(p.out) + (static_cast<size_t>(frame) * p.out_h + oy0) * p.out_w * 3;
  for (; ct * runs_t < p.runs; ct += d_ct) {
    const int ty = rt * rows_t + lane % rows_t, run = ct * runs_t + lane / rows_t;
    rt += d_rt;
    if (rt >= n_rt) {
      rt -= n_rt;
      ++ct;
    }
    if (ty >= n_out || run >= p.runs) continue;
    float yv[1][kRun] = {}, uv[2][kRun] = {};
    {
      const Staged s[1] = {st[0]};
      resample_run<1, KY, SPAN>(yv, s, L.w, L.pitch, vs_l[ty] - v0[0], band_t + L.vw + ty * ky_l,
                                xs_l[run], shared_t + L.wrun + run * (span_l * kRun + kTilePad), L.ky,
                                L.span);
    }
    {
      const Staged s[2] = {st[1], st[2]};
      resample_run<2, KYC, SPANC>(uv, s, C.w, C.pitch, vs_c[ty] - v0[1], band_t + C.vw + ty * ky_c,
                                  xs_c[run], shared_t + C.wrun + run * (span_c * kRun + kTilePad), C.ky,
                                  C.span);
    }
    float rgb[kRun * 3];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      const float yy = __fmul_rn(cy, __fadd_rn(yv[0][q], -yoff));
      const float uf = uv[0][q] - 128.f, vf = uv[1][q] - 128.f;
      const float r = __fadd_rn(yy, __fmul_rn(rv, vf));
      const float g = __fadd_rn(__fadd_rn(yy, __fmul_rn(gu, uf)), __fmul_rn(gv, vf));
      const float b = __fadd_rn(yy, __fmul_rn(bu, uf));
      rgb[q * 3 + 0] = fminf(fmaxf(r, 0.f), 1.f);
      rgb[q * 3 + 1] = fminf(fmaxf(g, 0.f), 1.f);
      rgb[q * 3 + 2] = fminf(fmaxf(b, 0.f), 1.f);
    }
    const int n = min(kRun, p.out_w - run * kRun);
    store_run(out + (static_cast<size_t>(ty) * p.out_w + run * kRun) * 3, rgb, n);
  }
}

template <typename OutT, int KY, int SPAN, int KYC, int SPANC>
int launch(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = preprocess_yuv_kernel<OutT, KY, SPAN, KYC, SPANC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_frames * p.n_bands, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The compile-time instantiations: ops/yuv.py's K3_TAPS mirrors this table
// (tests/test_torch_port_yuv.py checks it).
template <typename OutT>
int dispatch(const Params& p, bool is_static, int smem, cudaStream_t s) {
  if (!is_static) return launch<OutT, 0, 0, 0, 0>(p, smem, s);
  const Plane &L = p.plane[0], &C = p.plane[1];
#define K3_CASE(KY, SPAN, KYC, SPANC)                                        \
  if (L.ky == KY && L.span == SPAN && C.ky == KYC && C.span == SPANC) \
    return launch<OutT, KY, SPAN, KYC, SPANC>(p, smem, s);
  K3_CASE(2, 12, 2, 8) K3_CASE(4, 32, 2, 16) K3_CASE(8, 64, 4, 32)
#undef K3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes). `in` is (n_frames, row_len) uint8 spanning
// in_bytes (the packed [Y | U | V | tag] rows); `out` (n_frames, out_h, out_w, 3) float32
// (out_bf16 == 0) or bfloat16. `tables` and `geom` come from ops/yuv.py:k3_plan: geom =
// {h, w, runs, band_rows, warp_rows, shared_words, band_words, then per plane (luma, chroma): col0,
// n_cols, ky, span, rows_buf, pitch, xs, wrun, vstart, vw}. One block per (frame, band).
// Returns the cudaError_t of the launch.
extern "C" int ted_preprocess_yuv(const uint8_t* in, long long in_bytes, void* out, int out_bf16,
                                  const float* tables, long long row_len, int has_tag,
                                  int clip_frames, int n_frames, int out_h, int out_w,
                                  const int* geom, int is_static, int smem, void* stream) {
  if (clip_frames < 1 || n_frames % clip_frames != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.in = in;
  p.in_bytes = static_cast<unsigned long long>(in_bytes);
  p.out = out;
  p.tables = tables;
  p.row_len = row_len;
  p.has_tag = has_tag;
  p.clip_frames = clip_frames;
  p.n_frames = n_frames;
  p.out_h = out_h;
  p.out_w = out_w;
  const int h = geom[0], w = geom[1];
  p.runs = geom[2];
  p.band_rows = geom[3];
  p.n_bands = (out_h + p.band_rows - 1) / p.band_rows;
  p.warp_rows = geom[4];
  p.shared_words = geom[5];
  p.band_words = geom[6];
  if (p.warp_rows < 1 || 32 % p.warp_rows != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < 2; ++q) {
    const int* g = geom + 7 + 10 * q;
    Plane& pl = p.plane[q];
    pl.h = q == 0 ? h : h / 2;
    pl.w = q == 0 ? w : w / 2;
    pl.offset = q == 0 ? 0 : static_cast<long long>(h) * w;
    pl.col0 = g[0], pl.n_cols = g[1], pl.ky = g[2], pl.span = g[3];
    pl.rows_buf = g[4], pl.pitch = g[5];
    pl.xs = g[6], pl.wrun = g[7], pl.vstart = g[8], pl.vw = g[9];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<__nv_bfloat16>(p, is_static, smem, s)
                  : dispatch<float>(p, is_static, smem, s);
}
