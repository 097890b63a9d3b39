// K4: int8 implicit-GEMM convolution with the W8A8 epilogue fused into its store, for
// Hopper (sm_90a).
//
// Replaces the int8 convolutions of the JAX package's W8A8 serving mode,
// `_Quantizer.conv` (ted_spad_tpu/ops/quant_unetpp.py:125-144), and the elementwise ops
// XLA fuses after them there: XLA runs `conv_general_dilated(int8, int8) -> int32` on the
// TPU's matrix unit, then the dequant, the folded BatchNorm, the residual add, ReLU and
// the requantization at the next site. PyTorch has no CUDA int8 convolution
// (torch._int_mm covers matmuls only), so this kernel is the port's. It computes, per
// output value, in this order and each step rounded to the compute type CT (bfloat16 on
// the serving path, float32 in the tests):
//     y = CT(float32(acc) * scale[c])        acc: int8 x int8 products summed in int32
//     y = CT(y + bias[c])                    the conv's bias, where it has one
//     y = CT(CT(y * bn_scale[c]) + bn_bias[c])   a folded eval BatchNorm
//     y = CT(y + r)                          r: a CT residual, or CT(float32(code) * s_res)
//     y = max(y, 0)                          ReLU
//     out = int8(clamp(rint(y * inv_out), -127, 127))   or out = y in CT
// where scale[c] = float32(w_scale[c] * act_scale), computed here from the float32 weight
// scales and the activation scale rounded to float32 as torch rounds a Python scalar,
// and inv_out is the host's float32 of the Python double 1 / s_out. Every operation is one float32 operation written
// with __fmul_rn / __fadd_rn, so nvcc cannot contract a multiply and an add into an FMA,
// and every rounding to bf16 is round-to-nearest-even: the sequence of torch operations
// in the plain version (ops/int8conv.py: int8_conv_reference, int32 sums exact in
// float64) gives the same bits.
//
// Shapes. x is NDHWC int8 (2D convs run as D = 1), contiguous; the weights are packed
// once by the host (ops/int8conv.py: pack_weight) as (Cout, Kpad) int8 rows, K index =
// tap * Cin32 + c with each tap's Cin zero-padded to a multiple of 32 and Kpad a
// multiple of kBK. Any (kd, kh, kw) taps, strides, explicit low pads (the high pads are
// implied by the output size the host passes), lhs dilation (the up2_int8 form of the
// UNet++ decoder: a 4x4 kernel over the input with zeros between its pixels), any Cin
// (Cin a multiple of 16 stages by cp.async; others, such as the I3Res50 stem's Cin 3,
// byte by byte), and a ragged M (output pixels) and Cout, masked. The residual and the
// output are (M, Cout), contiguous.
//
// What bounds it on an H100. Per output pixel the conv does 2 * taps * Cin * Cout int8
// operations and moves its input, its residual (2 bytes bf16 or 1 byte int8 a value)
// and its output (1 byte int8 or 2 bytes bf16): at the 79 convs of a 16-clip serving
// step (UNet++ encoder and decoder convs over 256 frames, I3Res50 bottlenecks over 16
// clips) the bytes at 3.35 TB/s outweigh the operations at 1,979 TOPS; chip_smoke.py
// prints which bounds each shape. Below the card's ridge the gain is in moving fewer
// bytes: the fused epilogue writes int8 codes where the consumer is another int8 conv
// and reads the residual once, in place of eight elementwise passes over bf16 and
// float32 tensors.
//
// Design (each step measured on the card; PERF.md holds the numbers):
// - A block owns a tile of (output pixels x Cout): 8 warps, each a 32 x 32 warp tile = 2
//   m16 x 4 n8 tiles of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 accumulating in
//   int32 registers; 128 x 64 (Wide), or 256 x 32 (Narrow) in the 3x3 kernel at Cout <= 32.
// - Operands are staged by 16-byte cp.async whose src-size 0 zero-fills the halo, the
//   pads, the dilation holes, the channels past Cin and the rows past M / Cout, as K2
//   does (csrc/doubleconv.cu); fragments are read by 32-bit shared loads (each lane's 4
//   int8 of a row are contiguous in the m16n8k32 layout) from rows padded so that the 8
//   rows x 4 words a warp reads land on 32 distinct banks. (ldmatrix read no faster.)
// - The general kernel (any taps, strides, pads, dilation, Cin): K walks 32-byte chunks
//   of (tap, Cin); a stage holds kBK = 64 bytes of K of the gathered input rows (A) and
//   of the packed weight rows (B) in a 3-stage ring, two stages in flight. Each thread
//   stages one chunk of one A row a stage, its row's coordinates decoded once and its
//   (tap, chunk) advanced by carries, without a division. 128-byte stages were slower:
//   their ring leaves 2 blocks an SM where 64-byte ones leave 3-4.
// - The 3x3 kernel (kd 1, a 3 x 3 window, stride 1, no dilation, Cin a multiple of 16:
//   the UNet++'s unstrided 2D 3x3 convs and the I3Res50's unstrided (1, 3, 3) ones):
//   its gathers from L2, nine per input row, were half the general kernel's time there.
//   A block owns a 2D tile of one image's output pixels; a stage holds one 32-byte Cin
//   chunk of the tile's input patch with its one-pixel halo and of the nine taps' weight
//   rows, and the nine taps read the patch from shared memory (K2's design).
// - Epilogue: the block's residual tile is staged by 16-byte cp.async into its own
//   shared region with the first stage (element by element where a row is not 16-byte
//   aligned). Each thread runs the operations above on its accumulators and writes the
//   results as pairs into an output tile in shared memory (the ring is free by then);
//   the block then stores the tile with 16-byte stores along Cout.
// - Instantiations: compute type (bf16, f32) x output (CT, int8) x (general with
//   cp.async or byte-wise Cin staging, 3x3 Wide, 3x3 Narrow); the bias, the BatchNorm,
//   the residual's kind and ReLU are runtime flags, uniform over the block.
// - Next (ROADMAP): wgmma fed by TMA (its im2col mode for the A gather).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMT = 2, kNT = 4;      // m16 / n8 tiles of a warp's 32 x 32 tile
constexpr int kPackBytes = 64;       // packed weight rows are multiples (ops/int8conv.py: K4_BK)
// The 3x3 kernel's stages: patch rows of one 32-byte Cin chunk padded to 48 bytes, weight
// rows of the nine taps' chunks padded to 304 bytes (the 8 rows a warp reads land on
// distinct banks in both), two stages.
constexpr int kPLD = 32 + 16;
constexpr int kBLD = 9 * 32 + 16;
constexpr int kPStages = 2;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// A block's output tile: BN channels, its 8 warps' 32 x 32 tiles BN / 32 along Cout, so
// 256 * 32 / BN pixels; shared tiles of it in rows padded by 16 bytes; and the 3x3
// kernel's kTH x kTW pixels with their input patch (a one-pixel halo).
template <int BN>
struct Tile {
  static constexpr int kBN = BN, kWarpsN = BN / 32, kBM = kThreads / kWarpsN;
  __host__ __device__ static constexpr int ld(int elt) { return kBN * elt + 16; }
  __host__ __device__ static constexpr int bytes(int elt) { return kBM * ld(elt); }
  static constexpr int kTW = 16, kTH = kBM / kTW, kPW = kTW + 2, kPatchRows = (kTH + 2) * kPW;
  static constexpr int kPStageBytes = kPatchRows * kPLD + kBN * kBLD;
  static constexpr int kPRingBytes = kPStages * kPStageBytes;
  static_assert(kTH == 2 * (kThreads / 32 / kWarpsN), "a warp's two m16 tiles are two tile rows");
};
using Wide = Tile<64>;    // 128 pixels x 64 channels: every conv but the next
using Narrow = Tile<32>;  // 256 pixels x 32 channels: the 3x3 kernel at Cout <= 32

// The general kernel's tile and stages.
constexpr int kBM = Wide::kBM, kBN = Wide::kBN, kWarpsN = Wide::kWarpsN;
constexpr int kBK = 64;              // bytes of K per stage: kChunks 32-byte chunks
constexpr int kChunks = kBK / 32;
constexpr int kAChunks = kChunks / 2;  // A chunks a thread stages per stage (2 threads a row)
constexpr int kBSegs = kBK / 64;       // B 16-byte segments a thread stages (4 threads a row)
constexpr int kLDS = kBK + 16;       // padded shared row
constexpr int kStages = 3;           // ring depth: kStages - 1 stages in flight
constexpr int kStageBytes = (kBM + kBN) * kLDS;
constexpr int kRingBytes = kStages * kStageBytes;

enum ResKind { kNoRes = 0, kComputeRes = 1, kInt8Res = 2 };

struct Params {
  const int8_t* x;
  const int8_t* wt;  // packed weights
  const float* w_scale;  // (cout,) float32
  float act_scale;       // the input's scale, rounded to float32
  void* out;
  const void* bias;     // (cout,) CT or null
  const void* bn_s;     // (cout,) CT or null
  const void* bn_b;     // (cout,) CT, with bn_s
  const void* res;      // (m, cout) CT or int8, by res_kind
  int res_kind;
  float res_scale;      // dequant scale of an int8 residual
  int relu;
  float out_inv;        // 1 / s_out of an int8 output
  int res_vec, out_vec; // rows 16-byte aligned: staged and stored by 16 bytes
  int n, d, h, w, cin, cout;
  int kd, kh, kw;
  int sd, sh, sw;
  int pd, ph, pw;  // low pads
  int dd, dh, dw;  // lhs (input) dilation
  int od, oh, ow;
  int cin32;    // Cin rounded up to 32, in chunks
  int kchunks;  // taps * cin32: the 32-byte chunks of K that hold data
  int kpad;     // bytes per packed weight row, a multiple of kBK
  long long m;  // n * od * oh * ow
};

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a @ b for one m16n8k32 tile: a row-major 16x32 int8, b column-major 32x8 int8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 32-byte chunk of K: chunk c of tap (td, th, tw).
struct Cursor {
  int c, tw, th, td;
};
// The chunk n chunks further along K, by carries instead of divisions.
__device__ __forceinline__ void advance(Cursor& q, int n, int cin32, int kw, int kh) {
  q.c += n;
  while (q.c >= cin32) {
    q.c -= cin32;
    if (++q.tw == kw) {
      q.tw = 0;
      if (++q.th == kh) {
        q.th = 0;
        ++q.td;
      }
    }
  }
}

// The input coordinate of a dilated coordinate z along one axis, or -1 when z falls on
// the padding or a dilation hole.
__device__ __forceinline__ int source(int z, int dil, int size) {
  if (z < 0) return -1;
  if (dil != 1) {
    if (z % dil) return -1;
    z /= dil;
  }
  return z < size ? z : -1;
}

// The compute type's rounding, its loads from global or shared memory, and the store of
// a pair of already-rounded values into shared memory.
template <typename CT> struct Compute;
template <> struct Compute<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load(const void* p, int i) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ void store2(unsigned char* o, float a, float b) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  }
};
template <> struct Compute<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(const void* p, int i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  static __device__ __forceinline__ void store2(unsigned char* o, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  }
};

// int8 code of v at 1 / s = inv: round half to even, clamp to +-127, as torch.round and
// torch.clamp do.
__device__ __forceinline__ int requant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// The residual tile of a block: T::kBM rows (global row rowm(row), or -1 past the output) x
// T::kBN channels from n0, staged into res_s by 16-byte cp.async when its rows are 16-byte
// aligned (the caller commits the group), else by the epilogue byte by byte.
template <typename CT, typename T, typename RowMap>
__device__ __forceinline__ void stage_residual(const Params& p, unsigned char* res_s, int n0,
                                               RowMap rowm) {
  if (p.res_kind == kNoRes || !p.res_vec) return;
  const int res_elt = p.res_kind == kInt8Res ? 1 : static_cast<int>(sizeof(CT));
  const int res_ld = T::ld(res_elt), cpr = T::kBN * res_elt / 16;  // 16-byte chunks a row
  const unsigned char* res = static_cast<const unsigned char*>(p.res);
  for (int idx = threadIdx.x; idx < T::kBM * cpr; idx += kThreads) {
    const int row = idx / cpr, ch = idx - row * cpr;
    const long long mr = rowm(row);
    const bool ok = mr >= 0 && (n0 + ch * 16 / res_elt) < p.cout;
    const unsigned char* src = ok ? res + (static_cast<size_t>(mr) * p.cout + n0) * res_elt + ch * 16 : res;
    cp_async16(smem_addr(res_s + row * res_ld + ch * 16), src, ok);
  }
}

// The epilogue of a block's kBM x kBN tile, once every thread is past its main loop:
// the operations of the note above on the accumulators, the results written as pairs
// into an output tile at the start of shared memory (the ring is free by then), then
// stored along Cout by 16 bytes (byte by byte where rows are not 16-byte aligned).
template <typename CT, typename T, bool kInt8Out, typename RowMap>
__device__ __forceinline__ void epilogue(const Params& p, const int (&acc)[kMT][kNT][4],
                                         unsigned char* smem, unsigned char* res_s, int n0,
                                         RowMap rowm) {
  using R = Compute<CT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  constexpr int kOutElt = kInt8Out ? 1 : static_cast<int>(sizeof(CT));
  const int res_elt = p.res_kind == kInt8Res ? 1 : static_cast<int>(sizeof(CT));
  const int res_ld = T::ld(res_elt);
  cp_async_wait_all();
  __syncthreads();
  if (p.res_kind != kNoRes && !p.res_vec) {
    const unsigned char* res = static_cast<const unsigned char*>(p.res);
    for (int idx = threadIdx.x; idx < T::kBM * T::kBN; idx += kThreads) {
      const int row = idx / T::kBN, col = idx - row * T::kBN;
      const long long mr = rowm(row);
      if (mr < 0 || n0 + col >= p.cout) continue;
      const unsigned char* src = res + (static_cast<size_t>(mr) * p.cout + n0 + col) * res_elt;
      for (int b = 0; b < res_elt; ++b) res_s[row * res_ld + col * res_elt + b] = src[b];
    }
    __syncthreads();
  }
  unsigned char* const out_s = smem;
  constexpr int kOutLd = T::ld(kOutElt);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn * 32 + j * 8 + 2 * t;  // this thread's two channels: col, col + 1
    float sc[2], bi[2], bs[2], bb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(n0 + col + e, p.cout - 1);  // past Cout: computed, never stored
      sc[e] = __fmul_rn(p.w_scale[c], p.act_scale);
      bi[e] = p.bias ? R::load(p.bias, c) : 0.f;
      bs[e] = p.bn_s ? R::load(p.bn_s, c) : 0.f;
      bb[e] = p.bn_s ? R::load(p.bn_b, c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + i * 16 + g + half * 8;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = R::round(__fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), sc[e]));
          if (p.bias) y = R::round(__fadd_rn(y, bi[e]));
          if (p.bn_s) y = R::round(__fadd_rn(R::round(__fmul_rn(y, bs[e])), bb[e]));
          if (p.res_kind == kComputeRes) {
            y = R::round(__fadd_rn(y, R::load(res_s + row * res_ld, col + e)));
          } else if (p.res_kind == kInt8Res) {
            const int code = static_cast<int8_t>(res_s[row * res_ld + col + e]);
            y = R::round(__fadd_rn(y, R::round(__fmul_rn(__int2float_rn(code), p.res_scale))));
          }
          if (p.relu && y < 0.f) y = 0.f;
          v[e] = y;
        }
        unsigned char* o = out_s + row * kOutLd + col * kOutElt;
        if constexpr (kInt8Out) {
          const int q0 = requant(v[0], p.out_inv), q1 = requant(v[1], p.out_inv);
          *reinterpret_cast<uint16_t*>(o) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        } else {
          R::store2(o, v[0], v[1]);
        }
      }
    }
  }
  __syncthreads();
  unsigned char* const out = static_cast<unsigned char*>(p.out);
  if (p.out_vec) {
    constexpr int kCpr = T::kBN * kOutElt / 16;
    for (int idx = threadIdx.x; idx < T::kBM * kCpr; idx += kThreads) {
      const int row = idx / kCpr, ch = idx - row * kCpr;
      const long long mr = rowm(row);
      if (mr < 0 || n0 + ch * 16 / kOutElt >= p.cout) continue;
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(mr) * p.cout + n0) * kOutElt + ch * 16) =
          *reinterpret_cast<const uint4*>(out_s + row * kOutLd + ch * 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < T::kBM * T::kBN; idx += kThreads) {
      const int row = idx / T::kBN, col = idx - row * T::kBN;
      const long long mr = rowm(row);
      if (mr < 0 || n0 + col >= p.cout) continue;
      unsigned char* dst = out + (static_cast<size_t>(mr) * p.cout + n0 + col) * kOutElt;
      for (int b = 0; b < kOutElt; ++b) dst[b] = out_s[row * kOutLd + col * kOutElt + b];
    }
  }
}

// Shared bytes of a launch: its ring, or the output tile where that is larger, and the
// residual tile past them.
template <typename CT, typename T, bool kInt8Out>
__host__ __device__ constexpr int res_offset(int ring_bytes) {
  return imax(ring_bytes, T::bytes(kInt8Out ? 1 : static_cast<int>(sizeof(CT))));
}
template <typename CT, typename T, bool kInt8Out>
__host__ __device__ constexpr int smem_bytes(int ring_bytes, int res_kind) {
  const int res = res_kind == kNoRes ? 0 : T::bytes(res_kind == kInt8Res ? 1 : static_cast<int>(sizeof(CT)));
  return res_offset<CT, T, kInt8Out>(ring_bytes) + res;
}

// The general kernel: any taps, strides, pads, dilation and Cin.
template <typename CT, bool kInt8Out, bool kVecCin>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const auto rowm = [&](int row) -> long long { return m0 + row < p.m ? m0 + row : -1; };

  // This thread's A row (one output pixel) and the kAChunks 32-byte K chunks of a stage
  // it stages, from chunk a_half * kAChunks.
  const int a_row = threadIdx.x / 2, a_half = threadIdx.x % 2;
  const long long m = m0 + a_row;
  const bool m_ok = m < p.m;
  int zd = 0, zh = 0, zw = 0;
  size_t img = 0;  // element offset of this row's (n) image
  if (m_ok) {
    long long r = m;
    const int ox = static_cast<int>(r % p.ow); r /= p.ow;
    const int oy = static_cast<int>(r % p.oh); r /= p.oh;
    const int oz = static_cast<int>(r % p.od); r /= p.od;
    img = static_cast<size_t>(r) * p.d * p.h * p.w * p.cin;
    zd = oz * p.sd - p.pd;
    zh = oy * p.sh - p.ph;
    zw = ox * p.sw - p.pw;
  }
  // This thread's B row (one output channel) and its kBSegs 16-byte segments of a stage.
  const int b_row = threadIdx.x / 4, b_seg = (threadIdx.x % 4) * kBSegs;
  const bool n_ok = n0 + b_row < p.cout;
  const int8_t* b_src = p.wt + static_cast<size_t>(n_ok ? n0 + b_row : 0) * p.kpad + b_seg * 16;
  const int khw = p.kh * p.kw;
  // The first chunk this thread stages, at stage 0, decoded once.
  Cursor cur;
  {
    const int kc = a_half * kAChunks;
    const int tap = kc / p.cin32;
    cur.c = kc - tap * p.cin32;
    cur.td = tap / khw;
    const int rem = tap - cur.td * khw;
    cur.th = rem / p.kw;
    cur.tw = rem - cur.th * p.kw;
  }

  unsigned char* const res_s = smem + res_offset<CT, Wide, kInt8Out>(kRingBytes);
  stage_residual<CT, Wide>(p, res_s, n0, rowm);

  // A: the 32 bytes of chunk q for row a_row into dst, zero where the chunk falls on
  // the padding, a dilation hole, past Cin or past K.
  auto stage_chunk = [&](unsigned char* dst, const Cursor& q) {
    bool ok = m_ok && q.td < p.kd;
    const int c0 = q.c * 32;
    const int8_t* src = p.x;
    if (ok) {
      const int id = source(zd + q.td, p.dd, p.d), ih = source(zh + q.th, p.dh, p.h),
                iw = source(zw + q.tw, p.dw, p.w);
      ok = id >= 0 && ih >= 0 && iw >= 0;
      if (ok) src = p.x + img + ((static_cast<size_t>(id) * p.h + ih) * p.w + iw) * p.cin + c0;
    }
    if constexpr (kVecCin) {
      cp_async16(smem_addr(dst), ok ? src : p.x, ok && c0 < p.cin);
      cp_async16(smem_addr(dst + 16), ok ? src + 16 : p.x, ok && c0 + 16 < p.cin);
    } else {
#pragma unroll 4
      for (int b = 0; b < 32; ++b)
        dst[b] = ok && c0 + b < p.cin ? static_cast<unsigned char>(src[b]) : 0;
    }
  };
  // Stage s of the ring: this thread's A chunks and B segments.
  auto load = [&](int s) {
    unsigned char* st = smem + (s % kStages) * kStageBytes;
    unsigned char* a_dst = st + a_row * kLDS + a_half * kAChunks * 32;
    Cursor q = cur;
#pragma unroll
    for (int k = 0; k < kAChunks; ++k) {
      stage_chunk(a_dst + k * 32, q);
      if (k + 1 < kAChunks) advance(q, 1, p.cin32, p.kw, p.kh);
    }
    advance(cur, kChunks, p.cin32, p.kw, p.kh);
#pragma unroll
    for (int k = 0; k < kBSegs; ++k) {
      const int off = s * kBK + (b_seg + k) * 16;  // packed rows end at kpad, a multiple of 64
      cp_async16(smem_addr(st + (kBM + b_row) * kLDS + (b_seg + k) * 16), b_src + s * kBK + k * 16,
                 n_ok && off < p.kpad);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int n_stages = (p.kpad + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1's readers are done
    if (s + kStages - 1 < n_stages) load(s + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % kStages) * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kChunks; ++ks) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const unsigned char* row = st + (kBM + wn * 32 + j * 8 + g) * kLDS + ks * 32 + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(row);
        b[j][1] = *reinterpret_cast<const uint32_t*>(row + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const unsigned char* row = st + (wm * 32 + i * 16 + g) * kLDS + ks * 32 + t * 4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(row),
                               *reinterpret_cast<const uint32_t*>(row + 8 * kLDS),
                               *reinterpret_cast<const uint32_t*>(row + 16),
                               *reinterpret_cast<const uint32_t*>(row + 8 * kLDS + 16)};
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  epilogue<CT, Wide, kInt8Out>(p, acc, smem, res_s, n0, rowm);
}

// The 3x3 kernel: kd = 1 and a 3 x 3 window, stride 1, no dilation, Cin a multiple of 16
// (the unstrided 2D 3x3 convs of the UNet++ and the I3Res50's unstrided (1, 3, 3) ones,
// each depth slice an image). A block owns a kTH x kTW tile of one image's output
// pixels (kBM rows, masked past the image) x kBN channels; a stage holds one 32-byte Cin
// chunk of the tile's input patch with its halo ((kTH + 2) x (kTW + 2) pixels) and of the
// nine taps of the block's weight rows, so the nine taps read the patch from shared
// memory instead of gathering their rows from L2 each.
template <typename CT, typename T, bool kInt8Out>
__global__ void __launch_bounds__(kThreads) int8_conv3x3_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int tiles_w = (p.ow + T::kTW - 1) / T::kTW, tiles_h = (p.oh + T::kTH - 1) / T::kTH;
  int b = blockIdx.x;
  const int ox0 = (b % tiles_w) * T::kTW;
  b /= tiles_w;
  const int oy0 = (b % tiles_h) * T::kTH;
  const int image = b / tiles_h;  // (n, depth slice)
  const int n0 = blockIdx.y * T::kBN;
  const int8_t* const x_img = p.x + static_cast<size_t>(image) * p.h * p.w * p.cin;
  const long long m_img = static_cast<long long>(image) * p.oh * p.ow;
  const auto rowm = [&](int row) -> long long {
    const int oy = oy0 + row / T::kTW, ox = ox0 + row % T::kTW;
    return oy < p.oh && ox < p.ow ? m_img + static_cast<long long>(oy) * p.ow + ox : -1;
  };
  unsigned char* const res_s = smem + res_offset<CT, T, kInt8Out>(T::kPRingBytes);
  stage_residual<CT, T>(p, res_s, n0, rowm);

  // Stage s: Cin chunk s of the patch (zero past the image and past Cin) and of the
  // nine taps of weight rows n0.. (zero past Cout; the packed rows are zero past Cin).
  auto load = [&](int s) {
    unsigned char* st = smem + (s % kPStages) * T::kPStageBytes;
    const int c0 = s * 32;
    for (int idx = threadIdx.x; idx < T::kPatchRows * 2; idx += kThreads) {
      const int r = idx / 2, half = idx % 2;
      const int py = r / T::kPW, px = r - py * T::kPW;
      const int iy = oy0 - p.ph + py, ix = ox0 - p.pw + px;
      const bool ok = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w && c0 + half * 16 < p.cin;
      const int8_t* src = ok ? x_img + (static_cast<size_t>(iy) * p.w + ix) * p.cin + c0 + half * 16 : p.x;
      cp_async16(smem_addr(st + r * kPLD + half * 16), src, ok);
    }
    unsigned char* bs = st + T::kPatchRows * kPLD;
    for (int idx = threadIdx.x; idx < T::kBN * 18; idx += kThreads) {
      const int row = idx / 18, seg = idx - row * 18;  // seg: tap * 2 + half
      const bool ok = n0 + row < p.cout;
      const int8_t* src = p.wt + static_cast<size_t>(ok ? n0 + row : 0) * p.kpad +
                          ((seg / 2) * p.cin32 + s) * 32 + (seg % 2) * 16;
      cp_async16(smem_addr(bs + row * kBLD + seg * 16), src, ok);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int n_stages = p.cin32;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1's readers are done
    if (s + kPStages - 1 < n_stages) load(s + kPStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % kPStages) * T::kPStageBytes;
    const unsigned char* bs = st + T::kPatchRows * kPLD;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ty = tap / 3, tx = tap % 3;
      uint32_t bf[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const unsigned char* row = bs + (wn * 32 + j * 8 + g) * kBLD + tap * 32 + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(row);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(row + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // m16 tile i is output row wm * 2 + i of the tile, its 16 pixels; lane rows g and
        // g + 8 read patch row (that row + ty, pixel + tx).
        const unsigned char* row = st + ((wm * 2 + i + ty) * T::kPW + tx + g) * kPLD + t * 4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(row),
                               *reinterpret_cast<const uint32_t*>(row + 8 * kPLD),
                               *reinterpret_cast<const uint32_t*>(row + 16),
                               *reinterpret_cast<const uint32_t*>(row + 8 * kPLD + 16)};
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  epilogue<CT, T, kInt8Out>(p, acc, smem, res_s, n0, rowm);
}

// One launch: above 48 KB a block's dynamic shared memory must be allowed first, once
// per kernel, for the most any launch of it asks (its ring and the largest residual).
template <typename CT, typename T, bool kInt8Out, typename Kernel>
int launch_kernel(Kernel kernel, bool& allowed, int ring_bytes, dim3 grid, const Params& p,
                  cudaStream_t stream) {
  if (!allowed) {
    const int most = imax(smem_bytes<CT, T, kInt8Out>(ring_bytes, kComputeRes),
                          smem_bytes<CT, T, kInt8Out>(ring_bytes, kInt8Res));
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  const int smem = smem_bytes<CT, T, kInt8Out>(ring_bytes, p.res_kind);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, typename T, bool kInt8Out>
int launch3x3(const Params& p, cudaStream_t stream) {
  static bool allowed = false;
  const long long tiles = static_cast<long long>(p.n) * p.od * ((p.oh + T::kTH - 1) / T::kTH) *
                          ((p.ow + T::kTW - 1) / T::kTW);
  const unsigned n_tiles = (p.cout + T::kBN - 1) / T::kBN;
  if (tiles > 2147483647LL || n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel<CT, T, kInt8Out>(int8_conv3x3_kernel<CT, T, kInt8Out>, allowed,
                                        T::kPRingBytes, dim3(static_cast<unsigned>(tiles), n_tiles),
                                        p, stream);
}

template <typename CT, bool kInt8Out>
int launch(const Params& p, cudaStream_t stream) {
  const bool three_by_three = p.kd == 1 && p.kh == 3 && p.kw == 3 && p.sd == 1 && p.sh == 1 &&
                              p.sw == 1 && p.pd == 0 && p.od == p.d && p.dd == 1 && p.dh == 1 &&
                              p.dw == 1 && p.cin % 16 == 0;
  if (three_by_three)
    return p.cout <= Narrow::kBN ? launch3x3<CT, Narrow, kInt8Out>(p, stream)
                                 : launch3x3<CT, Wide, kInt8Out>(p, stream);
  static bool allowed[2] = {false, false};
  const unsigned n_tiles = (p.cout + kBN - 1) / kBN;
  const long long m_tiles = (p.m + kBM - 1) / kBM;
  if (m_tiles > 2147483647LL || n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles), n_tiles);
  if (p.cin % 16 == 0)
    return launch_kernel<CT, Wide, kInt8Out>(int8_conv_kernel<CT, kInt8Out, true>, allowed[1],
                                             kRingBytes, grid, p, stream);
  return launch_kernel<CT, Wide, kInt8Out>(int8_conv_kernel<CT, kInt8Out, false>, allowed[0],
                                           kRingBytes, grid, p, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). x (n, d, h, w, cin) int8, contiguous,
// 16-byte aligned when cin % 16 == 0; w (cout, kpad) int8 packed by
// ops/int8conv.py:pack_weight; w_scale (cout,) float32, the weights' scales, and
// act_scale, x's scale; out (n, od, oh, ow, cout): int8
// (out_int8 != 0) or the compute type, bfloat16 (compute_bf16 != 0) or float32. geom =
// {kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw, od, oh, ow}: taps, strides, low pads,
// lhs dilation and the output size. The epilogue: bias, bn_scale / bn_bias ((cout,) in
// the compute type, or null), residual (out's shape: the compute type for res_kind 1,
// int8 codes of scale res_scale for res_kind 2, null for 0), relu, and out_inv = 1 /
// s_out for an int8 output. Returns the cudaError_t of the launch (0 on success).
extern "C" int ted_int8_conv(const void* x, const void* w, const float* w_scale,
                             float act_scale, void* out,
                             int compute_bf16, int out_int8, int n, int d, int h, int wd,
                             int cin, int cout, const int* geom, int kpad, const void* bias,
                             const void* bn_scale, const void* bn_bias, const void* residual,
                             int res_kind, float res_scale, int relu, float out_inv,
                             void* stream) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.w_scale = w_scale;
  p.act_scale = act_scale;
  p.out = out;
  p.bias = bias;
  p.bn_s = bn_scale;
  p.bn_b = bn_bias;
  p.res = residual;
  p.res_kind = res_kind;
  p.res_scale = res_scale;
  p.relu = relu;
  p.out_inv = out_inv;
  p.n = n, p.d = d, p.h = h, p.w = wd, p.cin = cin, p.cout = cout;
  p.kd = geom[0], p.kh = geom[1], p.kw = geom[2];
  p.sd = geom[3], p.sh = geom[4], p.sw = geom[5];
  p.pd = geom[6], p.ph = geom[7], p.pw = geom[8];
  p.dd = geom[9], p.dh = geom[10], p.dw = geom[11];
  p.od = geom[12], p.oh = geom[13], p.ow = geom[14];
  p.cin32 = (cin + 31) / 32;
  p.kchunks = p.kd * p.kh * p.kw * p.cin32;
  p.kpad = kpad;
  p.m = static_cast<long long>(n) * p.od * p.oh * p.ow;
  const int ct_elt = compute_bf16 ? 2 : 4;
  const int out_elt = out_int8 ? 1 : ct_elt, res_elt = res_kind == kInt8Res ? 1 : ct_elt;
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.res_vec = res_kind != kNoRes && cout * res_elt % 16 == 0 && aligned(residual);
  p.out_vec = cout * out_elt % 16 == 0 && aligned(out);
  if (p.m <= 0 || cout <= 0 || kpad % kPackBytes != 0 || kpad < p.kchunks * 32 || res_kind < 0 ||
      res_kind > 2 || (res_kind != kNoRes) != (residual != nullptr) || (bn_scale == nullptr) != (bn_bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16)
    return out_int8 ? launch<__nv_bfloat16, true>(p, s) : launch<__nv_bfloat16, false>(p, s);
  return out_int8 ? launch<float, true>(p, s) : launch<float, false>(p, s);
}
