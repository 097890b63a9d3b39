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
// f32 keeps the first port's design on CUDA-core FMAs (a 4 x 8 tile, staged
// synchronously): it serves only the f32 checks and paths.
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

constexpr int kThreads = 256;  // the f32 kernel's block
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
// f32: CUDA-core FMAs over a 4 x 8 tile, staged synchronously. The haloed patch is
// staged with a row pitch of TW+4 pixels and conv1's rows use the same pitch, so tap
// (dy, dx) is the A matrix dy*(TW+4) + dx rows further on; the two extra columns per
// row are computed and dropped. conv2 does the same over the conv1 tile (pitch TW+2).

namespace f32 {

constexpr int TH = 4, TW = 8, KC = 16, NC = 64;
constexpr int P1 = TW + 4;                    // patch pitch = conv1 row pitch
constexpr int M1 = (TH + 2) * P1;             // conv1 GEMM rows (halo tile)
constexpr int M1P = round16(M1);
constexpr int PATCH = (TH + 4) * P1;          // real patch rows
constexpr int PATCH_ROWS = M1P + 2 * P1 + 2;  // rows conv1 reads
constexpr int P2 = TW + 2;                    // conv1-tile pitch = conv2 row pitch
constexpr int M2 = TH * P2;                   // conv2 GEMM rows
constexpr int M2P = round16(M2);
constexpr int MID = (TH + 2) * P2;            // real conv1-tile rows
constexpr int MID_ROWS = M2P + 2 * P2 + 2;    // rows conv2 reads
constexpr int LDX = KC + 8, LDW = NC + 8;
static_assert(PATCH <= PATCH_ROWS && MID <= MID_ROWS, "tile geometry");

__host__ __device__ int mid_ld(int cmid) { return round16(cmid) + 8; }
__host__ __device__ size_t mid_bytes(int cmid) {
  return align128(static_cast<size_t>(MID_ROWS) * mid_ld(cmid) * 4);
}
constexpr size_t kXsBytes = align128(static_cast<size_t>(PATCH_ROWS) * LDX * 4);
constexpr size_t kWsBytes = static_cast<size_t>(9) * KC * LDW * 4;

// xs[r][k] = x[y0 - 2 + r / P1][x0 - 2 + r % P1][c0 + k], zero outside the image,
// past Cin and on the rows after the real patch.
__device__ void stage_patch(float* xs, const float* __restrict__ xf, int y0, int x0, int c0,
                            int h, int w, int cin) {
  if (cin % 4 == 0) {
    constexpr int KV = KC / 4;
    for (int i = threadIdx.x; i < PATCH_ROWS * KV; i += kThreads) {
      const int r = i / KV, kv = i - r * KV;
      const int gy = y0 - 2 + r / P1, gx = x0 - 2 + r % P1, c = c0 + kv * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < PATCH && gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin)
        v = __ldg(reinterpret_cast<const float4*>(xf + (static_cast<size_t>(gy) * w + gx) * cin + c));
      *reinterpret_cast<float4*>(xs + r * LDX + kv * 4) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < PATCH_ROWS * KC; i += kThreads) {
    const int r = i / KC, k = i - r * KC;
    const int gy = y0 - 2 + r / P1, gx = x0 - 2 + r % P1, c = c0 + k;
    xs[r * LDX + k] = r < PATCH && gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin
                          ? xf[(static_cast<size_t>(gy) * w + gx) * cin + c]
                          : 0.f;
  }
}

// ws[tap][k][j] = wg[tap][c0 + k][n0 + j], zero past ci / co.
__device__ void stage_weights(float* ws, const float* __restrict__ wg, int c0, int n0, int ci,
                              int co) {
  if (co % 4 == 0) {
    constexpr int NV = NC / 4;
    for (int i = threadIdx.x; i < 9 * KC * NV; i += kThreads) {
      const int row = i / NV, nv = i - row * NV;  // row = tap * KC + k
      const int tap = row / KC, c = c0 + row - tap * KC, o = n0 + nv * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < ci && o < co)
        v = __ldg(reinterpret_cast<const float4*>(wg + (static_cast<size_t>(tap) * ci + c) * co + o));
      *reinterpret_cast<float4*>(ws + row * LDW + nv * 4) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < 9 * KC * NC; i += kThreads) {
    const int row = i / NC, j = i - row * NC;
    const int tap = row / KC, c = c0 + row - tap * KC, o = n0 + j;
    ws[row * LDW + j] = c < ci && o < co ? wg[(static_cast<size_t>(tap) * ci + c) * co + o] : 0.f;
  }
}

// Thread t owns column t % NC and rows t / NC + 4 r of an (M x NC) chunk.
template <int M>
struct Acc {
  static constexpr int kRowGroups = kThreads / NC;
  static constexpr int R = M / kRowGroups;
  static_assert(M % kRowGroups == 0, "rows per thread");
  float c[R];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = 0.f;
  }

  __device__ void mma(const float* a, int lda, const float* b, int ldb, int kc) {
    const int j = threadIdx.x % NC, m0 = threadIdx.x / NC;
    for (int k = 0; k < kc; ++k) {
      const float wv = b[k * ldb + j];
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = fmaf(a[(m0 + kRowGroups * r) * lda + k], wv, c[r]);
    }
  }

  template <class F>
  __device__ void each(int m_real, int ncw, F&& visit) {
    const int j = threadIdx.x % NC, m0 = threadIdx.x / NC;
    if (j >= ncw) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + kRowGroups * r;
      if (m < m_real) visit(m, j, c[r]);
    }
  }
};

__global__ void __launch_bounds__(kThreads)
double_conv(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, int h, int w, int cin,
            int cmid, int cout, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldm = mid_ld(cmid);
  float* mid = reinterpret_cast<float*>(smem);  // conv1 result, (MID_ROWS, ldm)
  unsigned char* stage = smem + mid_bytes(cmid);
  float* xs = reinterpret_cast<float*>(stage);             // (PATCH_ROWS, LDX)
  float* ws = reinterpret_cast<float*>(stage + kXsBytes);  // (9 * KC, LDW)

  const int frame = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int cin_p = round16(cin), cmid_p = round16(cmid), cout_p = round16(cout);
  const float* xf = x + static_cast<size_t>(frame) * h * w * cin;

  // Rows past the conv1 tile feed only conv2's dropped rows; keep them finite.
  for (int i = threadIdx.x; i < (MID_ROWS - MID) * ldm; i += kThreads) mid[MID * ldm + i] = 0.f;

  // conv1 over the haloed tile -> mid, chunk by chunk of Cmid.
  for (int n0 = 0; n0 < cmid_p; n0 += NC) {
    const int ncw = min(NC, cmid_p - n0);
    Acc<M1P> acc;
    acc.zero();
    for (int c0 = 0; c0 < cin_p; c0 += KC) {
      const int kc = min(KC, cin_p - c0);
      __syncthreads();  // the previous chunk's readers are done with xs/ws
      stage_patch(xs, xf, y0, x0, c0, h, w, cin);
      stage_weights(ws, w1, c0, n0, cin, cmid);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * P1 + tap % 3;
        acc.mma(xs + off * LDX, LDX, ws + tap * KC * LDW, LDW, kc);
      }
    }
    acc.each(M1, ncw, [&](int m, int j, float v) {
      const int i = m / P1, jj = m - i * P1;
      if (jj >= TW + 2) return;  // a dropped pitch column
      const int gy = y0 - 1 + i, gx = x0 - 1 + jj, c = n0 + j;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w && c < cmid;
      mid[(i * P2 + jj) * ldm + c] = inside ? fmaxf(v + b1[c], 0.f) : 0.f;
    });
  }

  // conv2 over mid -> out, chunk by chunk of Cout.
  for (int n0 = 0; n0 < cout_p; n0 += NC) {
    const int ncw = min(NC, cout_p - n0);
    Acc<M2P> acc;
    acc.zero();
    for (int c0 = 0; c0 < cmid_p; c0 += KC) {
      const int kc = min(KC, cmid_p - c0);
      __syncthreads();  // mid is complete; the previous readers of ws are done
      stage_weights(ws, w2, c0, n0, cmid, cout);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * P2 + tap % 3;
        acc.mma(mid + off * ldm + c0, ldm, ws + tap * KC * LDW, LDW, kc);
      }
    }
    acc.each(M2, ncw, [&](int m, int j, float v) {
      const int i = m / P2, jj = m - i * P2;
      const int gy = y0 + i, gx = x0 + jj, c = n0 + j;
      if (jj < TW && gy < h && gx < w && c < cout)
        out[((static_cast<size_t>(frame) * h + gy) * w + gx) * cout + c] = fmaxf(v + b2[c], 0.f);
    });
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

int launch_f32(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               void* out, int n, int h, int w, int cin, int cmid, int cout, cudaStream_t stream) {
  const int tiles_x = ceil_div(w, f32::TW);
  const dim3 grid(tiles_x * ceil_div(h, f32::TH), n);
  const size_t smem = f32::mid_bytes(cmid) + f32::kXsBytes + f32::kWsBytes;
  return launch_kernel(f32::double_conv, kThreads, smem, grid, stream, static_cast<const float*>(x),
                       static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2,
                       static_cast<float*>(out), h, w, cin, cmid, cout, tiles_x);
}

}  // namespace

// Plain C entry point (bound with ctypes). x (n, h, w, cin), w1 (3, 3, cin, cmid),
// w2 (3, 3, cmid, cout) and out (n, h, w, cout) are contiguous bfloat16
// (is_bf16 != 0) or float32; b1 (cmid,) and b2 (cout,) float32. Returns the
// cudaError_t of the launch (0 on success), or -2 when no tile class fits the conv1
// tile of this cmid in a block's shared memory.
extern "C" int ted_double_conv(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* out, int is_bf16, int n, int h, int w,
                               int cin, int cmid, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 64) return launch_bf16<ClassA64>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 128) return launch_bf16<ClassA>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 256) return launch_bf16<ClassB>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  if (cmid <= 512) return launch_bf16<ClassC>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  return kErrTooWide;
}
