// K4: int8 implicit-GEMM convolution with the W8A8 dequant epilogue, for Hopper (sm_90a).
//
// Replaces the int8 convolutions of the JAX package's W8A8 serving mode,
// `_Quantizer.conv` (ted_spad_tpu/ops/quant_unetpp.py:125-144): there XLA runs
// `conv_general_dilated(int8, int8) -> int32` on the TPU's matrix unit, then
//     out = (float32(acc) * (act_scale * w_scale[c])).astype(compute dtype)
// PyTorch has no CUDA int8 convolution (torch._int_mm covers matmuls only), so this
// kernel is the port's. It computes exactly that: int8 x int8 products summed in int32
// (exact), the int32 sum rounded to float32, one float32 multiply by the per-channel
// scale the host precomputed (act_scale * w_scale[c], in float32), and a
// round-to-nearest-even store in bfloat16 or float32. The plain version
// (ops/int8conv.py: int8_conv_reference) computes the same numbers, so the two agree
// bit for bit.
//
// Shapes. x is NDHWC int8 (2D convs run as D = 1), contiguous; the weights are packed
// once by the host (ops/int8conv.py: pack_weight) as (Cout, Kpad) int8 rows, K index =
// tap * Cin32 + c with each tap's Cin zero-padded to a multiple of 32 and Kpad a
// multiple of kBK. Any (kd, kh, kw) taps, strides, explicit low pads (the high pads are
// implied by the output size the host passes), lhs dilation (the up2_int8 form of the
// UNet++ decoder: a 4x4 kernel over the input with zeros between its pixels), any Cin
// (Cin a multiple of 16 stages by cp.async; others, such as the I3Res50 stem's Cin 3,
// byte by byte), and a ragged M (output pixels) and Cout, masked.
//
// What bounds it on an H100. Per output pixel the conv does 2 * taps * Cin * Cout int8
// operations and writes Cout bf16 values: at the 79 convs of a 16-clip serving step
// (UNet++ encoder and decoder convs over 256 frames, I3Res50 bottlenecks over 16 clips)
// the bytes at 3.35 TB/s (3.04 ms) outweigh the operations at 1,979 TOPS (2.20 ms);
// chip_smoke.py prints which bounds each shape.
//
// Design, simple and right first (a fused BN / ReLU / requant epilogue, then wgmma and
// TMA, are the redesign queued after it):
// - One block owns a kBM x kBN tile of (output pixels x Cout): 8 warps in a 4 x 2 grid,
//   each a 32 x 32 warp tile = 2 m16 x 4 n8 tiles of
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, accumulating in int32 registers.
// - K walks 32-byte chunks of (tap, Cin): a stage holds kBK = 64 bytes of K (two
//   chunks, possibly of two taps) for the A tile (the gathered input rows) and the B
//   tile (the packed weight rows), staged by 16-byte cp.async whose src-size 0
//   zero-fills the halo, the pads, the dilation holes, the channels past Cin and the
//   rows past M / Cout, as K2 does (csrc/doubleconv.cu). Two stages: the next one is in
//   flight while the MMAs read the current one.
// - Each thread stages one 32-byte K chunk of one A row per stage, so it decodes its
//   row's output coordinates once; a chunk's tap is decoded per stage.
// - Fragments are read by 32-bit shared loads (each lane's 4 int8 of a row are
//   contiguous in the m16n8k32 layout); rows are padded to 80 bytes, which puts the 8
//   rows x 4 words a warp reads on 32 distinct banks.
// - Epilogue from the accumulators: int32 -> float32 (round to nearest), times the
//   channel's scale, rounded to the output type, stored as bf16x2 / float2 pairs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;             // output pixels per block
constexpr int kBN = 64;              // output channels per block
constexpr int kBK = 64;              // bytes of K per stage: two 32-byte chunks
constexpr int kLDS = kBK + 16;       // padded shared row: 80 bytes
constexpr int kThreads = 256;
constexpr int kWarpsN = 2;
constexpr int kMT = 2, kNT = 4;      // m16 / n8 tiles per warp
constexpr int kStages = 2;
constexpr int kStageBytes = (kBM + kBN) * kLDS;

struct Params {
  const int8_t* x;
  const int8_t* wt;  // packed weights
  const float* scale;
  void* out;
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

// c += a @ b for one m16n8k32 tile: a row-major 16x32 int8, b column-major 32x8 int8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16_rn(a);
    if (second) o[1] = __float2bfloat16_rn(b);
  }
}
__device__ __forceinline__ void store2(float* o, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (second) o[1] = b;
  }
}

template <typename OutT, bool kVecCin>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // This thread's A row (one output pixel) and the K chunk of a stage it stages.
  const int a_row = threadIdx.x / 2, a_chunk = threadIdx.x % 2;
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
  // This thread's B row (one output channel) and 16-byte segment of a stage.
  const int b_row = threadIdx.x / 4, b_seg = threadIdx.x % 4;
  const bool n_ok = n0 + b_row < p.cout;
  const int8_t* b_src = p.wt + static_cast<size_t>(n_ok ? n0 + b_row : 0) * p.kpad + b_seg * 16;
  const int khw = p.kh * p.kw;

  auto load = [&](int s) {
    unsigned char* st = smem + (s % kStages) * kStageBytes;
    // A: one 32-byte chunk of K for row a_row.
    const int kc = s * 2 + a_chunk;
    unsigned char* a_dst = st + a_row * kLDS + a_chunk * 32;
    bool ok = m_ok && kc < p.kchunks;
    int c0 = 0;
    const int8_t* src = p.x;
    if (ok) {
      const int tap = kc / p.cin32;
      c0 = (kc - tap * p.cin32) * 32;
      const int td = tap / khw, rem = tap - td * khw;
      const int th = rem / p.kw, tw = rem - th * p.kw;
      const int id = source(zd + td, p.dd, p.d), ih = source(zh + th, p.dh, p.h),
                iw = source(zw + tw, p.dw, p.w);
      ok = id >= 0 && ih >= 0 && iw >= 0;
      if (ok) src = p.x + img + ((static_cast<size_t>(id) * p.h + ih) * p.w + iw) * p.cin + c0;
    }
    if constexpr (kVecCin) {
      cp_async16(smem_addr(a_dst), ok ? src : p.x, ok && c0 < p.cin);
      cp_async16(smem_addr(a_dst + 16), ok ? src + 16 : p.x, ok && c0 + 16 < p.cin);
    } else {
#pragma unroll 4
      for (int b = 0; b < 32; ++b)
        a_dst[b] = ok && c0 + b < p.cin ? static_cast<unsigned char>(src[b]) : 0;
    }
    // B: one 16-byte segment of the packed row of channel n0 + b_row.
    cp_async16(smem_addr(st + (kBM + b_row) * kLDS + b_seg * 16), b_src + s * kBK, n_ok);
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int n_stages = p.kpad / kBK;
  load(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed for every thread; stage s - 1's readers are done
    if (s + 1 < n_stages) load(s + 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % kStages) * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
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

  // Epilogue: float32(acc) * scale[c], rounded to the output type.
  OutT* out = static_cast<OutT*>(p.out);
  const bool even = p.cout % 2 == 0;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = n0 + wn * 32 + j * 8 + 2 * t;
    if (c >= p.cout) continue;
    const bool second = c + 1 < p.cout;
    const float s0 = p.scale[c], s1 = second ? p.scale[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm * 32 + i * 16 + g + half * 8;
        if (row >= p.m) continue;
        const float v0 = __int2float_rn(acc[i][j][2 * half]) * s0;
        const float v1 = __int2float_rn(acc[i][j][2 * half + 1]) * s1;
        store2(out + static_cast<size_t>(row) * p.cout + c, v0, v1, even && second, second);
      }
    }
  }
}

template <typename OutT>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = p.cin % 16 == 0 ? int8_conv_kernel<OutT, true> : int8_conv_kernel<OutT, false>;
  const int smem = kStages * kStageBytes;
  const long long m_tiles = (p.m + kBM - 1) / kBM;
  if (m_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles), (p.cout + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x (n, d, h, w, cin) int8, contiguous,
// 16-byte aligned when cin % 16 == 0; w (cout, kpad) int8 packed by
// ops/int8conv.py:pack_weight; scale (cout,) float32; out (n, od, oh, ow, cout)
// bfloat16 (out_bf16 != 0) or float32. geom = {kd, kh, kw, sd, sh, sw, pd, ph, pw, dd,
// dh, dw, od, oh, ow}: taps, strides, low pads, lhs dilation and the output size.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ted_int8_conv(const void* x, const void* w, const float* scale, void* out,
                             int out_bf16, int n, int d, int h, int wd, int cin, int cout,
                             const int* geom, int kpad, void* stream) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.scale = scale;
  p.out = out;
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
  if (p.m <= 0 || cout <= 0 || kpad % kBK != 0 || kpad < p.kchunks * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
