// K2: fused DoubleConv for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dconv_kernel` (ted_spad_tpu/ops/pallas_doubleconv.py:46),
// launched by `fused_double_conv` there. Both compute, per frame,
//     out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2)      (SAME padding)
// with eval BatchNorm and the conv bias folded into w/b, f32 accumulation, and the
// conv1 result rounded to the input dtype before conv2, kept on chip, and written as
// ZERO outside the image (conv2's SAME padding must see zeros, not
// relu(conv1(padding) + b1); pallas_doubleconv.py:82-88 masks the same way).
// x is (N, H, W, Cin), the NHWC view of a channels_last tensor; w1 (3, 3, Cin, Cmid),
// w2 (3, 3, Cmid, Cout); b1, b2 float32; out (N, H, W, Cout). Any H and W.
//
// What bounds it on an H100. Per pixel the function does 2*9*(Cin*Cmid + Cmid*Cout)
// FLOP against (Cin + Cout)*2 bytes of device memory: 576 FLOP/B at the 224^2 blocks
// and 1,152-4,505 elsewhere, all above the card's bf16 balance point (~295 FLOP/B), so
// every UNet shape is bound by operations. The second limit is inside the chip: each
// block streams all of w1 and w2 from L2, 18*(Cin*Cmid + Cmid*Cout) bytes, for its
// TH*TW output pixels, which is TH*TW useful FLOP per L2 byte: 98 at the 7x14 tile
// that Cmid 512 leaves room for, a stream the L2 cannot feed at the tensor cores' rate.
// Only more output pixels per block (a larger M) lowers it, and the conv1 tile in
// shared memory caps M by Cmid.
//
// Design (bf16). One block owns one frame's TH x TW output tile and runs two implicit
// GEMMs on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   conv1: M = (TH+2)*(TW+2) halo pixels (rounded to 16), N = Cmid, K = 9*Cin;
//   conv2: M = TH*TW (rounded to 16), N = Cout, K = 9*Cmid, A read from the conv1 tile.
// - Tile classes by Cmid (ClassA64 .. ClassC below), so that the conv1 tile (bf16) and
//   a two-stage ring fit: 16x16 outputs up to Cmid 64 (7 warps, two blocks per SM),
//   16x28 up to 128, 14x14 up to 256, 7x14 up to 512 (8 warps, one block per SM).
//   The UNet's frames (224, 112, 56, 28, 14) are multiples of the tiles that serve
//   them. The Python wrapper mirrors the table in ops/doubleconv.py:k2_tile_plan.
// - Taps as row gathers. Operands come in with ldmatrix (B with .trans); every lane
//   passes the address of its own A row, so tap (dy, dx) is a per-lane pixel offset
//   into the staged patch (conv1) or the conv1 tile (conv2), and no row is computed
//   only to be dropped, beyond the rounding of M to 16.
// - Warp tiles of MT m16 tiles x 4 n8 tiles (up to 64x32) in registers: one ldmatrix
//   feeds 2-4 MMAs. M tiles past the real M are skipped (warp-uniform).
// - Staging: cp.async 16-byte copies (src-size 0 zero-fills the halo outside the image
//   and the channels past Cin) into a ring of two stages, one stage in flight while the
//   other feeds the MMAs, one __syncthreads per stage. A conv1 stage is a KC-channel
//   chunk of the (TH+4) x (TW+4) patch plus w1[taps][KC][NC]; a conv2 stage is
//   w2[taps][KC][NC] (KC = 16, NC the class's N chunk). Rows are padded by 16 bytes to an odd number of 16-byte units,
//   so that ldmatrix over consecutive rows is free of bank conflicts. Channel counts
//   that are not multiples of 8 (inc's Cin = 3, padded to KC = 16) stage through
//   scalar loads and stores.
// - The conv1 patch chunk is restaged for each NC-wide chunk of Cmid: holding every
//   Cmid accumulator across the Cin loop does not fit in registers. This adds
//   (TH+4)(TW+4)/(9*NC) to the weight stream: 0.34 at 7x14, 0.56 at 14x14, 1.39 at
//   16x16 and 2.22 at 16x28 (NC = 32), where the weight stream per output is smallest.
// - Epilogue straight from the accumulators: bias, ReLU, the outside-image mask and
//   bf16 rounding, written as bf16x2 to the conv1 tile (conv1) or to device memory
//   (conv2). No f32 scratch tile.
// f32 (the float32 paths: the default visualization, the parity dry run's fa forwards)
// has its own design below: two passes of a register-blocked implicit GEMM on
// CUDA-core FMAs, bound by the FMA rate, with a float32 conv1 scratch in device memory.
//
// Left to a later change: wgmma from shared memory with TMA-fed, mbarrier-paced
// multi-stage pipelines, and a cluster of blocks sharing each weight chunk by TMA
// multicast (the L2 weight stream above divided by the cluster size); packing inc's
// 9 taps x 3 channels into K = 32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kErrTooWide = -2;  // no tile class fits this Cmid in shared memory

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }
__host__ __device__ constexpr int round16(int v) { return round_up(v, 16); }
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// ---------------------------------------------------------------------------------
// bf16: tensor cores through mma.sync, ldmatrix and cp.async.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a @ b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8, bf16 in.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kKC = 16;        // input channels per stage: one k16 step per tap
constexpr int kLDX = kKC + 8;  // staged patch row, padded to an odd count of 16 bytes
constexpr int kStages = 2;     // the staging ring

// A tile class: TH x TW outputs per block; the warp grid of both GEMMs, WM warps along
// M and WARPS / WM along N with 4 n8 tiles each; the blocks per SM that
// __launch_bounds__ holds registers to; the warps of a block.
template <int TH_, int TW_, int WM_, int MIN_BLOCKS_, int WARPS_>
struct Cls {
  static constexpr int TH = TH_, TW = TW_, WM = WM_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS = WARPS_, THREADS = 32 * WARPS;
  static constexpr int PW = TW + 4, PATCH = (TH + 4) * PW;  // staged input patch
  static constexpr int HW = TW + 2, M1 = (TH + 2) * HW;     // conv1 rows: the halo tile
  static constexpr int M2 = TH * TW;                        // conv2 rows: the tile
  static constexpr int NT = 4;                              // n8 tiles per warp
  static constexpr int WN = WARPS / WM, NC = WN * NT * 8;   // N chunk of both GEMMs
  static constexpr int MTILES1 = ceil_div(M1, 16), MT1 = ceil_div(MTILES1, WM);
  static constexpr int MTILES2 = ceil_div(M2, 16), MT2 = ceil_div(MTILES2, WM);
  static constexpr int LDW = NC + 8;                        // padded weight rows
  static constexpr int XS_BYTES = PATCH * kLDX * 2, W_BYTES = 9 * kKC * LDW * 2;
  static constexpr int STAGE_BYTES = static_cast<int>(align128(XS_BYTES + W_BYTES));
  static_assert(WARPS % WM == 0, "tile class");
  // conv1 tile: M1 rows of Cmid (rounded up to NC) bf16 channels plus 8 of padding.
  static __host__ __device__ int mid_ld(int cmid) { return round_up(cmid, NC) + 8; }
  static size_t smem_bytes(int cmid) {
    return align128(static_cast<size_t>(M1) * mid_ld(cmid) * 2) + kStages * STAGE_BYTES;
  }
};

// Mirrored by ops/doubleconv.py:_K2_CLASSES.
using ClassA64 = Cls<16, 16, 7, 2, 7>;  // Cmid <= 64
using ClassA = Cls<16, 28, 8, 1, 8>;    // Cmid <= 128
using ClassB = Cls<14, 14, 4, 1, 8>;    // Cmid <= 256
using ClassC = Cls<7, 14, 4, 1, 8>;     // Cmid <= 512

// xs[r][k] = x[y0 - 2 + r / PW][x0 - 2 + r % PW][c0 + k], zero outside the image and
// past Cin: cp.async when Cin is a multiple of 8, scalar otherwise.
template <class C>
__device__ void stage_patch(bf16* xs, const bf16* __restrict__ xf, int y0, int x0, int c0, int h,
                            int w, int cin) {
  if (cin % 8 == 0) {
    constexpr int KV = kKC / 8;
    for (int i = threadIdx.x; i < C::PATCH * KV; i += C::THREADS) {
      const int r = i / KV, kv = i - r * KV;
      const int gy = y0 - 2 + r / C::PW, gx = x0 - 2 + r % C::PW, c = c0 + kv * 8;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin;
      const bf16* src = ok ? xf + (static_cast<size_t>(gy) * w + gx) * cin + c : xf;
      cp_async16(smem_addr(xs + r * kLDX + kv * 8), src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < C::PATCH * kKC; i += C::THREADS) {
      const int r = i / kKC, k = i - r * kKC;
      const int gy = y0 - 2 + r / C::PW, gx = x0 - 2 + r % C::PW, c = c0 + k;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin;
      xs[r * kLDX + k] = ok ? xf[(static_cast<size_t>(gy) * w + gx) * cin + c]
                              : __float2bfloat16_rn(0.f);
    }
  }
}

// ws[tap][k][j] = wg[tap][c0 + k][n0 + j] for 9 taps, kKC input and NC output channels,
// zero past ci / co: cp.async when co is a multiple of 8, scalar otherwise.
template <int NC, int THREADS>
__device__ void stage_weights(bf16* ws, const bf16* __restrict__ wg, int c0, int n0, int ci,
                              int co) {
  constexpr int KC = kKC, LDW = NC + 8;
  if (co % 8 == 0) {
    constexpr int NV = NC / 8;
    for (int i = threadIdx.x; i < 9 * KC * NV; i += THREADS) {
      const int row = i / NV, nv = i - row * NV;  // row = tap * KC + k
      const int tap = row / KC, c = c0 + row - tap * KC, o = n0 + nv * 8;
      const bool ok = c < ci && o < co;
      const bf16* src = ok ? wg + (static_cast<size_t>(tap) * ci + c) * co + o : wg;
      cp_async16(smem_addr(ws + row * LDW + nv * 8), src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 9 * KC * NC; i += THREADS) {
      const int row = i / NC, j = i - row * NC;
      const int tap = row / KC, c = c0 + row - tap * KC, o = n0 + j;
      ws[row * LDW + j] = c < ci && o < co ? wg[(static_cast<size_t>(tap) * ci + c) * co + o]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// acc[mt][nt] += sum over 9 taps and kKC channels of A(tap) @ B(tap) for one warp:
// `a_row[mt]` is the shared address of this lane's A row (tap (0, 0), channel 0),
// `a_pix` the byte distance between neighbouring pixels of A's image and `a_line`
// between neighbouring lines; `b` the shared address of this lane's B row (tap 0,
// k 0), with `b_tap` bytes per tap. Only the first `mt_live` m16 tiles hold real rows.
template <int MT, int NT>
__device__ __forceinline__ void mma_taps(float (&acc)[MT][NT][4], const uint32_t (&a_row)[MT],
                                         int mt_live, uint32_t a_pix, uint32_t a_line,
                                         uint32_t b, uint32_t b_tap) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t bf[NT][2];
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t r[4];
      ldsm_x4_trans(r, b + tap * b_tap + p * 32);
      bf[2 * p][0] = r[0];
      bf[2 * p][1] = r[1];
      bf[2 * p + 1][0] = r[2];
      bf[2 * p + 1][1] = r[3];
    }
    const uint32_t a_tap = (tap / 3) * a_line + (tap % 3) * a_pix;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < mt_live) {
        uint32_t af[4];
        ldsm_x4(af, a_row[mt] + a_tap);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
double_conv_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int h, int w, int cin,
                 int cmid, int cout, int tiles_x) {
  constexpr int KC = kKC, NT = C::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldm = C::mid_ld(cmid);
  bf16* mid = reinterpret_cast<bf16*>(smem);  // conv1 tile, (M1, ldm)
  unsigned char* ring = smem + align128(static_cast<size_t>(C::M1) * ldm * 2);

  const int frame = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * C::TH;
  const int x0 = (blockIdx.x % tiles_x) * C::TW;
  const bf16* xf = x + static_cast<size_t>(frame) * h * w * cin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // the accumulator fragment's row / column pair

  // Stages in order: conv1 by (Cmid chunk, Cin chunk), then conv2 by (Cout chunk, Cmid
  // chunk). Stage t lives in ring slot t % kStages.
  const int nk1 = ceil_div(cin, KC), nk2 = ceil_div(cmid, KC);
  const int t1 = nk1 * ceil_div(cmid, C::NC), t_end = t1 + nk2 * ceil_div(cout, C::NC);
  auto load = [&](int t) {
    if (t >= t_end) return;
    unsigned char* st = ring + (t % kStages) * C::STAGE_BYTES;
    if (t < t1) {
      const int c0 = (t % nk1) * KC;
      stage_patch<C>(reinterpret_cast<bf16*>(st), xf, y0, x0, c0, h, w, cin);
      stage_weights<C::NC, C::THREADS>(reinterpret_cast<bf16*>(st + C::XS_BYTES), w1, c0,
                                       (t / nk1) * C::NC, cin, cmid);
    } else {
      t -= t1;
      stage_weights<C::NC, C::THREADS>(reinterpret_cast<bf16*>(st), w2, (t % nk2) * KC,
                                       (t / nk2) * C::NC, cmid, cout);
    }
  };
  // Wait for stage t, let every warp finish with stage t - 1, start stage t + 1 into
  // the slot t - 1 used; returns the shared address of stage t.
  auto next_stage = [&](int t) {
    cp_async_wait_all();
    __syncthreads();
    load(t + 1);
    cp_async_commit();
    return smem_addr(ring + (t % kStages) * C::STAGE_BYTES);
  };

  load(0);
  cp_async_commit();
  int t = 0;

  // conv1 over the haloed tile -> mid.
  {
    const int wm = warp / C::WN, wn = warp % C::WN;
    const int mt_live = min(C::MT1, C::MTILES1 - wm * C::MT1);
    uint32_t a_row[C::MT1];  // byte offset of this lane's A row in the patch
#pragma unroll
    for (int mt = 0; mt < C::MT1; ++mt) {
      int m = (wm * C::MT1 + mt) * 16 + lane % 16;
      m = m < C::M1 ? m : 0;  // rows past M1 are computed and dropped
      a_row[mt] = ((m / C::HW) * C::PW + m % C::HW) * kLDX * 2 + (lane / 16) * 16;
    }
    const uint32_t b_lane = ((lane % 16) * C::LDW + wn * NT * 8 + (lane / 16) * 8) * 2;
    for (int n0 = 0; n0 < cmid; n0 += C::NC) {
      float acc[C::MT1][NT][4] = {};
      for (int k = 0; k < nk1; ++k, ++t) {
        const uint32_t st = next_stage(t);
        uint32_t a[C::MT1];
#pragma unroll
        for (int mt = 0; mt < C::MT1; ++mt) a[mt] = st + a_row[mt];
        mma_taps<C::MT1, NT>(acc, a, mt_live, kLDX * 2, C::PW * kLDX * 2,
                             st + C::XS_BYTES + b_lane, KC * C::LDW * 2);
      }
      // Epilogue: bias, ReLU, zero outside the image and past Cmid, bf16 into mid.
#pragma unroll
      for (int mt = 0; mt < C::MT1; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wm * C::MT1 + mt) * 16 + g + half * 8;
          if (mt >= mt_live || m >= C::M1) continue;
          const int gy = y0 - 1 + m / C::HW, gx = x0 - 1 + m % C::HW;
          const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + (wn * NT + nt) * 8 + 2 * tig;
            const float v0 = inside && n < cmid ? fmaxf(acc[mt][nt][2 * half] + b1[n], 0.f) : 0.f;
            const float v1 =
                inside && n + 1 < cmid ? fmaxf(acc[mt][nt][2 * half + 1] + b1[n + 1], 0.f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(mid + m * ldm + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }

  // conv2 over mid -> out. The first next_stage's barrier also publishes mid.
  {
    const int wm = warp / C::WN, wn = warp % C::WN;
    const int mt_live = min(C::MT2, C::MTILES2 - wm * C::MT2);
    const uint32_t mid_base = smem_addr(mid);
    uint32_t a_row[C::MT2];  // shared address of this lane's A row in mid
#pragma unroll
    for (int mt = 0; mt < C::MT2; ++mt) {
      int m = (wm * C::MT2 + mt) * 16 + lane % 16;
      m = m < C::M2 ? m : 0;  // rows past M2 are computed and dropped
      a_row[mt] = mid_base + ((m / C::TW) * C::HW + m % C::TW) * ldm * 2 + (lane / 16) * 16;
    }
    const uint32_t b_lane = ((lane % 16) * C::LDW + wn * NT * 8 + (lane / 16) * 8) * 2;
    bf16* out_f = out + static_cast<size_t>(frame) * h * w * cout;
    for (int n0 = 0; n0 < cout; n0 += C::NC) {
      float acc[C::MT2][NT][4] = {};
      for (int k = 0; k < nk2; ++k, ++t) {
        const uint32_t st = next_stage(t);
        uint32_t a[C::MT2];
#pragma unroll
        for (int mt = 0; mt < C::MT2; ++mt) a[mt] = a_row[mt] + k * KC * 2;
        mma_taps<C::MT2, NT>(acc, a, mt_live, ldm * 2, C::HW * ldm * 2, st + b_lane,
                             KC * C::LDW * 2);
      }
#pragma unroll
      for (int mt = 0; mt < C::MT2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wm * C::MT2 + mt) * 16 + g + half * 8;
          const int gy = y0 + m / C::TW, gx = x0 + m % C::TW;
          if (mt >= mt_live || m >= C::M2 || gy >= h || gx >= w) continue;
          bf16* o = out_f + (static_cast<size_t>(gy) * w + gx) * cout;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + (wn * NT + nt) * 8 + 2 * tig;
            if (n >= cout) continue;
            const float v0 = fmaxf(acc[mt][nt][2 * half] + b2[n], 0.f);
            if (n + 1 < cout) {
              const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + b2[n + 1], 0.f);
              if (cout % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(v0, v1);
              } else {
                o[n] = __float2bfloat16_rn(v0);
                o[n + 1] = __float2bfloat16_rn(v1);
              }
            } else {
              o[n] = __float2bfloat16_rn(v0);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------------
// f32: two passes of one implicit-GEMM conv3x3 + bias + ReLU on CUDA-core FMAs
// (products and sums in float32, no TF32). Pass 1 writes relu(conv3x3(x, w1) + b1) to
// a float32 scratch in device memory, pass 2 reads it as its input. The scratch's round
// trip is 8 * Cmid bytes a pixel against 18 * Cmid * (Cin + Cout) FLOP, so it costs
// about 3% of the operations bound, where a fused float32 tile (2 KB a pixel of conv1
// at Cmid 512) would be ~8x8 outputs and recompute half of conv1 again for its halo.
//
// One pass: out[m][o] = relu(b[o] + sum_k A[m][k] * B[k][o]) over
//   M = N * H * W pixels, flattened over frames, so that small frames fill the tiles;
//   N = the output channels;
//   K = 9 * Cin ordered (chunk of BK channels, tap): a stage holds one tap of one chunk,
//     so the 9 taps of a chunk re-read the same pixel lines from L1. A[m][k] is the
//     input pixel at tap (dy, dx) of pixel m, zero outside m's own frame (each pixel's
//     frame, row and column are known, so no tap reaches into a neighbouring frame),
//     past M and past Cin; B[k][o] = w[tap][c][o], which is row tap * Cin + c of the
//     HWIO weights seen as a (9 * Cin, Cout) matrix. Where Cin % 4 != 0 (inc's Cin 3),
//     K runs over that matrix's rows in order, 4-byte copies, so 27 rows fill 2 stages.
// What bounds it: the FMA pipes (128 float32 FMAs per SM per cycle, 67 TFLOP/s on an
// H100 SXM), where shared memory, the copies and the barriers keep up with them. So:
// - Register blocking: 128 threads (4 warps), each with an 8 x 8 output tile (64
//   accumulators) of a BM x BN block tile. Per 4 k a thread reads its 8 B columns as
//   two 16-byte vectors per k, then each of its 8 A rows as one 16-byte vector of the
//   4 k: 16 shared loads feed 256 FMAs. Its rows are tm + (BM / 8) i and its columns
//   tn * 4 + j and BN / 2 + tn * 4 + j, so that a quarter-warp reads one A row (a
//   broadcast) and 128 contiguous bytes of one B row, and A's rows are padded to 20
//   floats, so the quarter-warps' four rows fall in distinct banks.
// - Three blocks an SM (168 registers a thread, no spill on sm_90a): one block's
//   barrier and ring refill overlap the others' FMAs. One block of 256 threads an SM
//   took 1.13x as long, two of 256 threads at 128 registers spilled (PERF.md §6).
// - A 3-stage cp.async ring with src-size 0 zero-fill for every masked element, one
//   __syncthreads per stage: two stages are in flight while the third feeds the FMAs.
// - Weights are read once per BM-pixel tile (not once per 32 outputs), 36 * Cin * BN
//   bytes a block from L2; neighbouring blocks along M share them.
// - Epilogue from the registers: bias, ReLU, 16-byte stores (4-byte where Cout % 4 != 0),
//   ragged M and N masked.
// Two block tiles: 64 x 128, and 128 x 64 where Cout <= 64 so no half-empty N tile is
// computed (inc, up4 and up3's conv2 at the full and half frame). Mirrored by
// ops/doubleconv.py:k2_f32_plan.

namespace f32 {

constexpr int BK = 16;     // k rows per stage
constexpr int STAGES = 3;  // the cp.async ring
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;  // blocks an SM that __launch_bounds__ holds registers to
constexpr int LDA = BK + 4;  // A rows in shared memory, padded (see above)

template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int TM = BM / 8, TN = BN / 8;  // threads along M and N
  static constexpr int WN = TN / 8;               // warps along N (a warp: 4 x 8 threads)
  static constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * BN;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static constexpr int A_ROWS = BM * (BK / 4) / THREADS;  // 16-byte A copies a thread
  static_assert(TM * TN == THREADS && TN % 8 == 0, "8 x 8 outputs a thread, 4 x 8 threads a warp");
  static_assert(BM * (BK / 4) % THREADS == 0 && BK * BN / 4 % THREADS == 0, "copies a thread");
};

// Mirrored by ops/doubleconv.py:_K2_F32_TILES.
using TileWide = Tile<64, 128>;    // Cout > 64
using TileNarrow = Tile<128, 64>;  // Cout <= 64

__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// out = relu(conv3x3(x, w) + b) for x (M pixels of H x W frames, Cin), w (3, 3, Cin,
// Cout), out (M, Cout), all float32.
template <class T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv3x3(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
        float* __restrict__ out, int m_total, int h, int wd, int cin, int cout) {
  extern __shared__ __align__(128) float ring[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int hw = h * wd;
  const bool vec_a = cin % 4 == 0, vec_b = cout % 4 == 0;
  const int k_stages = vec_a ? 9 * ceil_div(cin, BK) : ceil_div(9 * cin, BK);

  // The pixels this thread copies on the 16-byte path, fixed over the stages: rows
  // tid / 4 + (THREADS / 4) j of the tile, channels 4 (tid % 4) of the stage's chunk.
  int a_pix[T::A_ROWS], a_yx[T::A_ROWS];
#pragma unroll
  for (int j = 0; j < T::A_ROWS; ++j) {
    const int m = m0 + tid / (BK / 4) + j * (THREADS / (BK / 4));
    const int r = m % hw;
    a_pix[j] = m < m_total ? m : -1;
    a_yx[j] = (r / wd) << 16 | (r % wd);
  }

  auto load = [&](int s) {
    if (s >= k_stages) return;
    float* as = ring + (s % STAGES) * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    if (vec_a) {
      const int tap = s % 9, c0 = s / 9 * BK, dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int c = c0 + (tid % (BK / 4)) * 4;
#pragma unroll
      for (int j = 0; j < T::A_ROWS; ++j) {
        const int y = (a_yx[j] >> 16) + dy, xx = (a_yx[j] & 0xffff) + dx;
        const bool ok = a_pix[j] >= 0 && y >= 0 && y < h && xx >= 0 && xx < wd && c < cin;
        const float* src = ok ? x + (static_cast<size_t>(a_pix[j] + dy * wd + dx) * cin + c) : x;
        const int row = tid / (BK / 4) + j * (THREADS / (BK / 4));
        cp_async_ca(smem_addr(as + row * LDA + (tid % (BK / 4)) * 4), src, ok);
      }
    } else {
      // One k column a thread (tid % BK), rows tid / BK + (THREADS / BK) j.
      const int k = s * BK + tid % BK, tap = k / cin, c = k - tap * cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      for (int row = tid / BK; row < T::BM; row += THREADS / BK) {
        const int m = m0 + row, r = m % hw, y = r / wd + dy, xx = r % wd + dx;
        const bool ok = m < m_total && k < 9 * cin && y >= 0 && y < h && xx >= 0 && xx < wd;
        const float* src = ok ? x + (static_cast<size_t>(m + dy * wd + dx) * cin + c) : x;
        cp_async_4(smem_addr(as + row * LDA + tid % BK), src, ok);
      }
    }
    // B: k rows of the (9 * Cin, Cout) weight matrix, BN columns from n0.
    const int k_base = vec_a ? (s % 9) * cin + s / 9 * BK : s * BK;
    const int k_end = vec_a ? (s % 9) * cin + cin : 9 * cin;
    if (vec_b) {
      for (int i = tid; i < BK * T::BN / 4; i += THREADS) {
        const int kk = i / (T::BN / 4), col = (i % (T::BN / 4)) * 4;
        const int k = k_base + kk, o = n0 + col;
        const bool ok = k < k_end && o < cout;
        const float* src = ok ? w + static_cast<size_t>(k) * cout + o : w;
        cp_async_ca(smem_addr(bs + kk * T::BN + col), src, ok);
      }
    } else {
      for (int i = tid; i < BK * T::BN; i += THREADS) {
        const int kk = i / T::BN, col = i % T::BN;
        const int k = k_base + kk, o = n0 + col;
        const bool ok = k < k_end && o < cout;
        const float* src = ok ? w + static_cast<size_t>(k) * cout + o : w;
        cp_async_4(smem_addr(bs + kk * T::BN + col), src, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int tm = (warp / T::WN) * 4 + lane / 8, tn = (warp % T::WN) * 8 + lane % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int s = 0; s < k_stages; ++s) {
    cp_async_wait_ring();  // stage s has landed (this thread's copies)
    __syncthreads();       // everyone's copies, and every reader is done with stage s - 1
    load(s + STAGES - 1);  // into the slot stage s - 1 used
    cp_async_commit();
    const float* as = ring + (s % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float bv[4][8];  // B[kq * 4 + kk][this thread's 8 columns]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bs + (kq * 4 + kk) * T::BN + tn * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + T::BN / 2);
        bv[kk][0] = b0.x, bv[kk][1] = b0.y, bv[kk][2] = b0.z, bv[kk][3] = b0.w;
        bv[kk][4] = b1.x, bv[kk][5] = b1.y, bv[kk][6] = b1.z, bv[kk][7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + (tm + T::TM * i) * LDA + kq * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[kk], bv[kk][j], acc[i][j]);
      }
    }
  }
  cp_async_wait_all();

  // Epilogue: bias, ReLU, masked stores.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int o = n0 + half * (T::BN / 2) + tn * 4;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = o + j < cout ? b[o + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tm + T::TM * i;
      if (m >= m_total) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(acc[i][half * 4 + j] + bias[j], 0.f);
      float* dst = out + static_cast<size_t>(m) * cout + o;
      if (vec_b && o + 3 < cout) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (o + j < cout) dst[j] = v[j];
      }
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------------
// Launch.

template <class... Params, class... Args>
int launch_kernel(void (*kernel)(Params...), int threads, size_t smem, dim3 grid,
                  cudaStream_t stream, Args... args) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return kErrTooWide;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_bf16(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                void* out, int n, int h, int w, int cin, int cmid, int cout, cudaStream_t stream) {
  const int tiles_x = ceil_div(w, C::TW);
  const dim3 grid(tiles_x * ceil_div(h, C::TH), n);
  return launch_kernel(double_conv_bf16<C>, C::THREADS, C::smem_bytes(cmid), grid, stream,
                       static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                       static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), h, w, cin,
                       cmid, cout, tiles_x);
}

template <class T>
int launch_f32_pass(const float* x, const float* w, const float* b, float* out, int n, int h,
                    int wd, int cin, int cout, cudaStream_t stream) {
  const int m_total = n * h * wd;
  const dim3 grid(ceil_div(m_total, T::BM), ceil_div(cout, T::BN));
  return launch_kernel(f32::conv3x3<T>, f32::THREADS, T::SMEM_BYTES, grid, stream, x, w, b, out,
                       m_total, h, wd, cin, cout);
}

int launch_f32_conv(const float* x, const float* w, const float* b, float* out, int n, int h,
                    int wd, int cin, int cout, cudaStream_t stream) {
  if (cout <= 64)
    return launch_f32_pass<f32::TileNarrow>(x, w, b, out, n, h, wd, cin, cout, stream);
  return launch_f32_pass<f32::TileWide>(x, w, b, out, n, h, wd, cin, cout, stream);
}

// Pass 1 into the scratch `mid` (n, h, w, cmid), pass 2 from it into out.
int launch_f32(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               void* mid, void* out, int n, int h, int w, int cin, int cmid, int cout,
               cudaStream_t stream) {
  float* m = static_cast<float*>(mid);
  const int err = launch_f32_conv(static_cast<const float*>(x), static_cast<const float*>(w1), b1, m,
                                  n, h, w, cin, cmid, stream);
  if (err != 0) return err;
  return launch_f32_conv(m, static_cast<const float*>(w2), b2, static_cast<float*>(out), n, h, w,
                         cmid, cout, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). x (n, h, w, cin), w1 (3, 3, cin, cmid),
// w2 (3, 3, cmid, cout) and out (n, h, w, cout) are contiguous bfloat16
// (is_bf16 != 0) or float32; b1 (cmid,) and b2 (cout,) float32; mid, float32 only:
// a scratch of n * h * w * cmid floats for the conv1 result (unused for bfloat16).
// Returns the cudaError_t of the launch (0 on success), or -2 when no tile class fits
// the bfloat16 conv1 tile of this cmid in a block's shared memory.
extern "C" int ted_double_conv(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* mid, void* out, int is_bf16, int n, int h,
                               int w, int cin, int cmid, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(x, w1, b1, w2, b2, mid, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 64) return launch_bf16<ClassA64>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 128) return launch_bf16<ClassA>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 256) return launch_bf16<ClassB>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 512) return launch_bf16<ClassC>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  return kErrTooWide;
}
