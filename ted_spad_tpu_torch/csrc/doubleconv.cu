// K2: fused DoubleConv for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dconv_kernel`, launched by `fused_double_conv` in
// ted_spad_tpu/ops/pallas_doubleconv.py. Both compute, per frame,
//     out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2)      (SAME padding)
// with eval BatchNorm and the conv bias folded into w/b, f32 accumulation, and the
// conv1 result rounded to the input dtype before conv2. x is (N, H, W, Cin), the
// NHWC view of a channels_last tensor; w1 (3, 3, Cin, Cmid), w2 (3, 3, Cmid, Cout);
// b1, b2 float32; out (N, H, W, Cout). Any H and W; bf16 or f32.
//
// Bound. At the plain UNet's nine shapes the work is bound by operations: per
// pixel it does 2*9*(Cin*Cmid + Cmid*Cout) FLOP against (Cin + Cout)*2 bytes moved,
// 576 FLOP/B at the two 224^2 blocks (inc 3->64->64, up4 128->64->64; the H100's
// bf16 balance point is ~295 FLOP/B, so these are the closest) and 1,152-4,505
// FLOP/B elsewhere. The fused form keeps the conv1 result out of device memory,
// which saves its write and re-read (at 112^2 128->64->64 for 256 frames, 411 MB
// each way, ~0.25 ms against a ~0.72 ms compute bound); beyond that the design
// spends its effort on tensor-core arithmetic, not on bytes.
//
// Design. The TPU kernel cut the frame into row bands sized for VMEM and a 128-wide
// MXU, one sequential grid step each. Here one block of 8 warps owns one frame's
// TH x TW output tile (8 x 8 in bf16) and computes it as two implicit GEMMs:
//   conv1: M = the tile plus a 1-px halo, N = Cmid, K = 9*Cin;
//   conv2: M = the tile, N = Cout, K = 9*Cmid (A read from shared memory).
// - Taps as row offsets. The haloed input patch is staged with a row pitch of
//   TW+4 pixels and conv1's M rows are laid out with the same pitch, so tap (dy, dx)
//   is the A matrix starting (dy*(TW+4) + dx) rows further on: every tap is a plain
//   strided tile load, no gather. The two extra columns per row are computed and
//   dropped. conv2 does the same over the conv1 tile with pitch TW+2.
// - The conv1 result (TH+2) x (TW+2) x Cmid stays in shared memory, rounded to the
//   input dtype: 10*10*512*2 B = 100 KB at Cmid = 512, inside the 227 KB a block may
//   use. Positions outside the image are written as ZERO, not as
//   relu(conv1(zero padding) + b1): conv2's SAME padding must see zeros
//   (pallas_doubleconv.py:82-88 masks the same way).
// - Cin and the weights stream from L2 in chunks of KC input channels x 64 output
//   channels (all 9 taps), zero-filled past Cin/Cmid/Cout, so channel counts that
//   are not multiples of 16 (inc's Cin = 3, i.e. K = 27) are padded here, not by
//   the caller.
// - bf16: nvcuda::wmma 16x16x16 tensor-core fragments, f32 accumulators, the
//   epilogue (bias, ReLU, mask, rounding) through a shared f32 tile. f32: the same
//   tiling on CUDA-core FMAs (a 4 x 8 tile, to fit the f32 conv1 result).
// - Cost of the halo: neighbouring tiles recompute conv1 on their halos, and the
//   pitch trick computes 2 dropped columns per row: conv1 runs 128 GEMM rows per 64
//   outputs (2.0x its work) and conv2 80 rows per 64 (1.25x). Staging is synchronous
//   (no cp.async/TMA pipeline) and uses mma.sync-class fragments, not wgmma. This is
//   a simple, exact first kernel; a wgmma/TMA redesign with larger tiles is the
//   known way to its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNC = 64;  // output channels per chunk (conv1: of Cmid, conv2: of Cout)
constexpr int kErrTooWide = -2;  // the conv1 tile does not fit in shared memory

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int TH = 8, TW = 8, KC = 32; };
template <> struct Tile<float> { static constexpr int TH = 4, TW = 8, KC = 16; };

template <typename T>
struct Geom {
  static constexpr int TH = Tile<T>::TH, TW = Tile<T>::TW, KC = Tile<T>::KC;
  static constexpr int P1 = TW + 4;                    // patch pitch = conv1 row pitch
  static constexpr int M1 = (TH + 2) * P1;             // conv1 GEMM rows (halo tile)
  static constexpr int M1P = round16(M1);
  static constexpr int PATCH = (TH + 4) * P1;          // real patch rows
  static constexpr int PATCH_ROWS = M1P + 2 * P1 + 2;  // rows conv1 reads
  static constexpr int P2 = TW + 2;                    // conv1-tile pitch = conv2 row pitch
  static constexpr int M2 = TH * P2;                   // conv2 GEMM rows
  static constexpr int M2P = round16(M2);
  static constexpr int MID = (TH + 2) * P2;            // real conv1-tile rows
  static constexpr int MID_ROWS = M2P + 2 * P2 + 2;    // rows conv2 reads
  static constexpr int PAD = 32 / sizeof(T);           // keeps rows 32-byte aligned
  static constexpr int LDX = KC + PAD;
  static constexpr int LDW = kNC + PAD;
  static constexpr int LDS = kNC + 4;                  // f32 epilogue tile
  static constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte load
  static_assert(PATCH <= PATCH_ROWS && MID <= MID_ROWS, "tile geometry");
  static_assert(M1P % 16 == 0 && M2P % 16 == 0 && M1P / 16 <= kWarps, "tile geometry");
};

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// xs[r][k] = x[y0 - 2 + r / P1][x0 - 2 + r % P1][c0 + k], zero outside the image,
// past Cin and on the rows after the real patch.
template <typename T>
__device__ void stage_patch(T* xs, const T* __restrict__ xf, int y0, int x0, int c0, int h,
                            int w, int cin) {
  using G = Geom<T>;
  constexpr int V = G::VEC;
  if (cin % V == 0) {
    constexpr int KV = G::KC / V;
    for (int i = threadIdx.x; i < G::PATCH_ROWS * KV; i += kThreads) {
      const int r = i / KV, kv = i - r * KV;
      const int pr = r / G::P1, pc = r - pr * G::P1;
      const int gy = y0 - 2 + pr, gx = x0 - 2 + pc, c = c0 + kv * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < G::PATCH && gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin)
        v = __ldg(reinterpret_cast<const uint4*>(xf + (static_cast<size_t>(gy) * w + gx) * cin + c));
      *reinterpret_cast<uint4*>(xs + r * G::LDX + kv * V) = v;
    }
  } else {
    for (int i = threadIdx.x; i < G::PATCH_ROWS * G::KC; i += kThreads) {
      const int r = i / G::KC, k = i - r * G::KC;
      const int pr = r / G::P1, pc = r - pr * G::P1;
      const int gy = y0 - 2 + pr, gx = x0 - 2 + pc, c = c0 + k;
      T v = from_float<T>(0.f);
      if (r < G::PATCH && gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin)
        v = xf[(static_cast<size_t>(gy) * w + gx) * cin + c];
      xs[r * G::LDX + k] = v;
    }
  }
}

// ws[tap][k][j] = wg[tap][c0 + k][n0 + j] for 9 taps, KC input and kNC output
// channels, zero past ci / co.
template <typename T>
__device__ void stage_weights(T* ws, const T* __restrict__ wg, int c0, int n0, int ci, int co) {
  using G = Geom<T>;
  constexpr int V = G::VEC;
  if (co % V == 0) {
    constexpr int NV = kNC / V;
    for (int i = threadIdx.x; i < 9 * G::KC * NV; i += kThreads) {
      const int row = i / NV, nv = i - row * NV;  // row = tap * KC + k
      const int tap = row / G::KC, k = row - tap * G::KC;
      const int c = c0 + k, o = n0 + nv * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < ci && o < co)
        v = __ldg(reinterpret_cast<const uint4*>(wg + (static_cast<size_t>(tap) * ci + c) * co + o));
      *reinterpret_cast<uint4*>(ws + row * G::LDW + nv * V) = v;
    }
  } else {
    for (int i = threadIdx.x; i < 9 * G::KC * kNC; i += kThreads) {
      const int row = i / kNC, j = i - row * kNC;
      const int tap = row / G::KC, k = row - tap * G::KC;
      const int c = c0 + k, o = n0 + j;
      T v = from_float<T>(0.f);
      if (c < ci && o < co) v = wg[(static_cast<size_t>(tap) * ci + c) * co + o];
      ws[row * G::LDW + j] = v;
    }
  }
}

// Accumulators of one chunk: an (M x ncw) f32 tile, ncw <= kNC a multiple of 16.
// mma(a, lda, b, ldb, kc): acc += A[0:M, 0:kc] @ B[0:kc, 0:ncw], A and B row-major
// in shared memory. each(...): visits (row, column, value) of the first m_real rows.
template <typename T, int M> struct Acc;

// bf16: tensor-core fragments; warp w owns fragments w*fpw .. w*fpw+fpw-1 of the
// (M/16) x (ncw/16) grid, row-major, so a warp reloads A only when its row changes.
template <int M>
struct Acc<bf16, M> {
  static constexpr int MT = M / 16;
  static constexpr int kMaxFrags = 4;  // MT <= 8 and ncw/16 <= 4: at most 32 fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kMaxFrags];
  int nt, nfrag, fpw;

  __device__ void zero(int ncw) {
    nt = ncw / 16;
    nfrag = MT * nt;
    fpw = (nfrag + kWarps - 1) / kWarps;
#pragma unroll
    for (int i = 0; i < kMaxFrags; ++i) wmma::fill_fragment(c[i], 0.f);
  }

  __device__ void mma(const bf16* a, int lda, const bf16* b, int ldb, int kc) {
    const int first = (threadIdx.x / 32) * fpw;
    for (int k = 0; k < kc; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      int loaded = -1;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int f = first + i;
        if (i < fpw && f < nfrag) {
          const int mt = f / nt, ntile = f - mt * nt;
          if (mt != loaded) {
            wmma::load_matrix_sync(fa, a + mt * 16 * lda + k, lda);
            loaded = mt;
          }
          wmma::load_matrix_sync(fb, b + k * ldb + ntile * 16, ldb);
          wmma::mma_sync(c[i], fa, fb, c[i]);
        }
      }
    }
  }

  // `scratch` may alias the staging buffers: the caller synchronises first.
  template <class F>
  __device__ void each(float* scratch, int m_real, int ncw, F&& visit) {
    constexpr int lds = Geom<bf16>::LDS;
    const int first = (threadIdx.x / 32) * fpw;
#pragma unroll
    for (int i = 0; i < kMaxFrags; ++i) {
      const int f = first + i;
      if (i < fpw && f < nfrag) {
        const int mt = f / nt, ntile = f - mt * nt;
        wmma::store_matrix_sync(scratch + mt * 16 * lds + ntile * 16, c[i], lds,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m_real * ncw; i += kThreads) {
      const int m = i / ncw, j = i - m * ncw;
      visit(m, j, scratch[m * lds + j]);
    }
  }
};

// f32: CUDA-core FMAs; thread t owns column t % kNC and rows t / kNC + 4 r.
template <int M>
struct Acc<float, M> {
  static constexpr int kRowGroups = kThreads / kNC;
  static constexpr int R = M / kRowGroups;
  static_assert(M % kRowGroups == 0, "rows per thread");
  float c[R];

  __device__ void zero(int) {
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = 0.f;
  }

  __device__ void mma(const float* a, int lda, const float* b, int ldb, int kc) {
    const int j = threadIdx.x % kNC, m0 = threadIdx.x / kNC;
    for (int k = 0; k < kc; ++k) {
      const float wv = b[k * ldb + j];
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = fmaf(a[(m0 + kRowGroups * r) * lda + k], wv, c[r]);
    }
  }

  template <class F>
  __device__ void each(float*, int m_real, int ncw, F&& visit) {
    const int j = threadIdx.x % kNC, m0 = threadIdx.x / kNC;
    if (j >= ncw) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + kRowGroups * r;
      if (m < m_real) visit(m, j, c[r]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
double_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, T* __restrict__ out, int h, int w, int cin,
                   int cmid, int cout, int tiles_x, int ldm, int mid_bytes, int xs_bytes) {
  using G = Geom<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* mid = reinterpret_cast<T*>(smem);  // conv1 result, (MID_ROWS, ldm)
  unsigned char* stage = smem + mid_bytes;
  T* xs = reinterpret_cast<T*>(stage);                // (PATCH_ROWS, LDX)
  T* ws = reinterpret_cast<T*>(stage + xs_bytes);     // (9 * KC, LDW)
  float* scratch = reinterpret_cast<float*>(stage);   // bf16 epilogue, aliases xs/ws

  const int frame = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * G::TH;
  const int x0 = (blockIdx.x % tiles_x) * G::TW;
  const int cin_p = round16(cin), cmid_p = round16(cmid), cout_p = round16(cout);
  const T* xf = x + static_cast<size_t>(frame) * h * w * cin;

  // Rows past the conv1 tile feed only conv2's dropped rows; keep them finite.
  for (int i = threadIdx.x; i < (G::MID_ROWS - G::MID) * ldm; i += kThreads)
    mid[G::MID * ldm + i] = from_float<T>(0.f);

  // conv1 over the haloed tile -> mid, chunk by chunk of Cmid.
  for (int n0 = 0; n0 < cmid_p; n0 += kNC) {
    const int ncw = min(kNC, cmid_p - n0);
    Acc<T, G::M1P> acc;
    acc.zero(ncw);
    for (int c0 = 0; c0 < cin_p; c0 += G::KC) {
      const int kc = min(G::KC, cin_p - c0);
      __syncthreads();  // the previous chunk's readers are done with xs/ws/scratch
      stage_patch<T>(xs, xf, y0, x0, c0, h, w, cin);
      stage_weights<T>(ws, w1, c0, n0, cin, cmid);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * G::P1 + tap % 3;
        acc.mma(xs + off * G::LDX, G::LDX, ws + tap * G::KC * G::LDW, G::LDW, kc);
      }
    }
    __syncthreads();
    acc.each(scratch, G::M1, ncw, [&](int m, int j, float v) {
      const int i = m / G::P1, jj = m - i * G::P1;
      if (jj >= G::TW + 2) return;  // a dropped pitch column
      const int gy = y0 - 1 + i, gx = x0 - 1 + jj, c = n0 + j;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w && c < cmid;
      mid[(i * G::P2 + jj) * ldm + c] = from_float<T>(inside ? fmaxf(v + b1[c], 0.f) : 0.f);
    });
  }

  // conv2 over mid -> out, chunk by chunk of Cout.
  for (int n0 = 0; n0 < cout_p; n0 += kNC) {
    const int ncw = min(kNC, cout_p - n0);
    Acc<T, G::M2P> acc;
    acc.zero(ncw);
    for (int c0 = 0; c0 < cmid_p; c0 += G::KC) {
      const int kc = min(G::KC, cmid_p - c0);
      __syncthreads();  // mid is complete; the previous readers of ws/scratch are done
      stage_weights<T>(ws, w2, c0, n0, cmid, cout);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * G::P2 + tap % 3;
        acc.mma(mid + off * ldm + c0, ldm, ws + tap * G::KC * G::LDW, G::LDW, kc);
      }
    }
    __syncthreads();
    acc.each(scratch, G::M2, ncw, [&](int m, int j, float v) {
      const int i = m / G::P2, jj = m - i * G::P2;
      const int gy = y0 + i, gx = x0 + jj, c = n0 + j;
      if (jj < G::TW && gy < h && gx < w && c < cout)
        out[((static_cast<size_t>(frame) * h + gy) * w + gx) * cout + c] =
            from_float<T>(fmaxf(v + b2[c], 0.f));
    });
  }
}

size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* out, int n, int h, int w, int cin, int cmid, int cout, cudaStream_t stream) {
  using G = Geom<T>;
  const int ldm = round16(cmid) + G::PAD;
  const size_t mid_bytes = align128(static_cast<size_t>(G::MID_ROWS) * ldm * sizeof(T));
  const size_t xs_bytes = align128(static_cast<size_t>(G::PATCH_ROWS) * G::LDX * sizeof(T));
  const size_t ws_bytes = static_cast<size_t>(9) * G::KC * G::LDW * sizeof(T);
  const size_t scratch_bytes =
      std::is_same<T, bf16>::value ? static_cast<size_t>(G::M1P) * G::LDS * sizeof(float) : 0;
  const size_t smem = mid_bytes + std::max(xs_bytes + ws_bytes, scratch_bytes);

  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return kErrTooWide;
  err = cudaFuncSetAttribute(double_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + G::TW - 1) / G::TW;
  const int tiles_y = (h + G::TH - 1) / G::TH;
  dim3 grid(tiles_x * tiles_y, n);
  double_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), h, w, cin, cmid, cout, tiles_x, ldm, static_cast<int>(mid_bytes),
      static_cast<int>(xs_bytes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x (n, h, w, cin), w1 (3, 3, cin, cmid),
// w2 (3, 3, cmid, cout) and out (n, h, w, cout) are contiguous bfloat16
// (is_bf16 != 0) or float32; b1 (cmid,) and b2 (cout,) float32. Returns the
// cudaError_t of the launch (0 on success), or -2 when the conv1 tile of this
// cmid does not fit in a block's shared memory.
extern "C" int ted_double_conv(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* out, int is_bf16, int n, int h, int w,
                               int cin, int cmid, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
  return launch<float>(x, w1, b1, w2, b2, out, n, h, w, cin, cmid, cout, s);
}
