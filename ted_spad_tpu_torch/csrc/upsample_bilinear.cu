// K6: the backward of the UNet's bilinear 2x upsample (align_corners=True),
// deterministic, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's `resize_bilinear`
// (ted_spad_tpu/models/layers.py:109) gathers with explicit weights in XLA, and its
// gradient is XLA's, the same bits on every run on a TPU. Torch's CUDA backward of
// `F.interpolate(mode="bilinear")` (`upsample_bilinear2d_backward`) adds each output's
// four taps into the input with atomics, so an input pixel's sum, fed by up to 4x4
// outputs at scale 2, comes out in another order on every run.
//
// Gather form, no atomics. Along each axis the outputs o that read input i are those
// whose taps i0 = (int)src, i1 = i0 + (i0 < in - 1) name it, with src = scale * o and
// scale = (in - 1) / (out - 1) computed in the data's type as torch's forward computes
// them; their weight along the axis is (i0 == i ? 1 - lam : 0) + (i1 == i ? lam : 0),
// lam = src - i0. With out = 2 in they lie in [2 i - 3, 2 i + 4] (8 candidates, one of
// margin at each end). Each input pixel's gradient is the separable sum, in a fixed
// order:
//     grad_in[iy, ix] = sum over oy ascending of wy * t[oy, ix],
//     t[oy, ix] = sum over ox ascending of wx * g[oy, ox],
// each product and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction),
// so the plain version (ops/upsample.py: upsample_bilinear_backward_reference), which
// adds the same masked products in the same order, is bit-equal to it.
//
// Bound: bytes. grad_out read once and grad_in written once: at the UNet's largest
// upsample (up4: 64 channels, 112^2 -> 224^2, float32) on the fa pretraining batch of 32
// frames 514 MB, 0.153 ms at 3.35 TB/s; a few dozen operations per input element. The
// first form (one thread per input pixel, its flat index split by runtime sizes, every
// read through 64-bit stride products, t recomputed for each of the ~2 input rows that
// read an output row, each grad_out value read by ~4 threads, 4 bytes a thread) took
// 0.97 ms, 1.1x torch's atomic backward; this one 0.20 ms device time, 1.3x the bound.
//
// The design:
// - Bands. A plane is one (n, c_outer): (n) with its H x W x C elements (channels_last:
//   c_outer 1, c_inner C) or (n, c) with its H x W (NCHW: c_outer C, c_inner 1). A
//   block owns a band of `band` input rows of one plane x blockDim.y columns x
//   blockDim.x channel vectors (blockIdx.z's); thread (x, y) takes one vector of column
//   ix. The wrapper's plan (ops/upsample.py: k6_plan) picks the vector width, the block
//   and the band (shorter where the grid would hold few blocks).
// - Tap tables, once. The rows' taps of the band's output rows go into shared memory,
//   one entry an output row (the rows it feeds in the band and their weights); each
//   thread keeps its column's 8 candidate taps in registers. Both come from the same
//   `tap` arithmetic as the sums above.
// - One pass down the band. Each thread walks the band's output rows oy ascending. It
//   computes t[oy, ix] once (ascending ox over its column's taps) and adds wy * t into
//   the accumulators of the (at most two) input rows oy feeds, a ring of two rows in
//   registers; a row leaves the ring, stored, once the rows' first tap passes it. Each
//   accumulator so receives wy * t in ascending oy: the order above. Output rows at a
//   band's edge are read by two bands; each computes their t with the same arithmetic.
// - Vectors. Where the plan allows (channels_last, C a multiple of the width, grad_out
//   with channel stride 1 and every other stride a multiple of the width, 16-byte
//   aligned), a thread takes 16 bytes of channels: 4 float32 or 2 float64, one 16-byte
//   load a tap and one 16-byte store a pixel. Elsewhere (NCHW, ragged C, other views)
//   the same kernel runs with one element a thread through grad_out's strides: that is
//   the generic path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScale = 2;           // out = 2 in on both axes, the UNet's
constexpr int kTaps = 4 * kScale;   // candidate outputs per axis
constexpr int kMaxBand = 32;        // input rows a block
constexpr int kMaxOutRows = kScale * kMaxBand + kTaps - kScale;  // output rows a band reads

struct Params {
  const void* grad_out;
  void* grad_in;
  int c_outer, c_inner;  // (1, C) channels_last, (C, 1) NCHW
  int cv;                // c_inner / vector width
  int h, w;
  int band, n_bands;
  // Strides in elements of (N, C, OH, OW). A sample's span below 2^31 elements (the
  // wrapper's limit) keeps every offset but the batch's in 32 bits.
  long long go_batch;
  int go_stride[3];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Whether output o reads input i along an axis of `in` inputs and `out` outputs, and its
// weight there, as torch's forward computes the taps (area_pixel_compute_scale and
// area_pixel_compute_source_index with align_corners=True).
template <typename T>
__device__ __forceinline__ bool tap(int o, int i, int in, T scale, T* weight) {
  const T src = mul_rn(scale, static_cast<T>(o));
  const int i0 = static_cast<int>(src);
  const int i1 = i0 + (i0 < in - 1 ? 1 : 0);
  if (i0 != i && i1 != i) return false;
  const T lam1 = sub_rn(src, static_cast<T>(i0));
  const T lam0 = sub_rn(static_cast<T>(1), lam1);
  *weight = add_rn(i0 == i ? lam0 : static_cast<T>(0), i1 == i ? lam1 : static_cast<T>(0));
  return true;
}

// An output row's taps into a band: its first tap i0 and, for each of the (at most
// two) input rows it feeds, the row (-1 where it is outside the band or outside that
// row's candidates) and the weight.
template <typename T>
struct RowTaps {
  int i0, lo, hi;
  T w_lo, w_hi;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Both launch bounds named: with the block size alone, ptxas may spill a few bytes to
// reach an occupancy step, and the build refuses any spill.
template <typename T, int V>
__global__ void __launch_bounds__(256, 3) upsample_bilinear_backward_band(const Params p) {
  __shared__ RowTaps<T> taps[kMaxOutRows];
  const int oh = p.h * kScale, ow = p.w * kScale;
  // torch: (in - 1) / (out - 1) in the accumulate type.
  const T scale_y = static_cast<T>(p.h - 1) / static_cast<T>(oh - 1);
  const T scale_x = static_cast<T>(p.w - 1) / static_cast<T>(ow - 1);
  // 32-bit: a 64-bit division is a called routine, which spills.
  const int band = static_cast<int>(blockIdx.x % static_cast<unsigned>(p.n_bands));
  const unsigned plane = blockIdx.x / static_cast<unsigned>(p.n_bands);
  const int ia = band * p.band;
  const int ib = ia + p.band < p.h ? ia + p.band : p.h;
  const int oa = kScale * ia - kScale - 1 > 0 ? kScale * ia - kScale - 1 : 0;
  const int ob = kScale * (ib - 1) + 3 * kScale - 2 < oh - 1 ? kScale * (ib - 1) + 3 * kScale - 2 : oh - 1;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  for (int k = tid; k <= ob - oa; k += blockDim.x * blockDim.y) {
    const int oy = oa + k;
    const int i0 = static_cast<int>(mul_rn(scale_y, static_cast<T>(oy)));
    const int i1 = i0 + (i0 < p.h - 1 ? 1 : 0);
    RowTaps<T> e{i0, -1, -1, 0, 0};
    // A row takes oy where oy is one of its candidates and reads it.
    if (i0 >= ia && i0 < ib && oy >= kScale * i0 - kScale - 1 && oy <= kScale * i0 + 3 * kScale - 2 &&
        tap(oy, i0, p.h, scale_y, &e.w_lo)) {
      e.lo = i0;
    }
    if (i1 != i0 && i1 >= ia && i1 < ib && oy >= kScale * i1 - kScale - 1 &&
        oy <= kScale * i1 + 3 * kScale - 2 && tap(oy, i1, p.h, scale_y, &e.w_hi)) {
      e.hi = i1;
    }
    taps[k] = e;
  }
  __syncthreads();
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= p.w) return;
  // The column's candidates ox = 2 ix - 3 + j, ascending: which read ix, and how much.
  const int x_lo = kScale * ix - kScale - 1;
  T wx[kTaps];
  unsigned hit_x = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const int ox = x_lo + j;
    if (ox >= 0 && ox < ow && tap(ox, ix, p.w, scale_x, &wx[j])) hit_x |= 1u << j;
  }
  const int co = static_cast<int>(plane % static_cast<unsigned>(p.c_outer));
  const T* go = static_cast<const T*>(p.grad_out) + (plane / static_cast<unsigned>(p.c_outer)) * p.go_batch;
  const int gs1 = p.go_stride[0], gs2 = p.go_stride[1], gs3 = p.go_stride[2];
  T* gi = static_cast<T*>(p.grad_in) + static_cast<long long>(plane) * p.h * p.w * p.c_inner + ix * p.c_inner;
  const int row_pitch = p.w * p.c_inner;
  for (int cv = blockIdx.z * blockDim.x + threadIdx.x; cv < p.cv; cv += gridDim.z * blockDim.x) {
    // Vector widths above 1 come with channel strides of 1 (the plan's condition).
    const int col = (co + cv * V) * gs1 + x_lo * gs3;
    T* out = gi + cv * V;
    T acc0[V], acc1[V];  // the ring: rows cur and cur + 1
#pragma unroll
    for (int l = 0; l < V; ++l) acc0[l] = acc1[l] = 0;
    int cur = ia;
    for (int oy = oa; oy <= ob; ++oy) {
      const RowTaps<T> e = taps[oy - oa];
      while (e.i0 > cur && cur < ib) {  // row cur has had every output row that reads it
        Pack<T, V> s;
#pragma unroll
        for (int l = 0; l < V; ++l) s.v[l] = acc0[l], acc0[l] = acc1[l], acc1[l] = 0;
        *reinterpret_cast<Pack<T, V>*>(out + cur * row_pitch) = s;
        ++cur;
      }
      if (cur >= ib) break;
      if (e.lo < 0 && e.hi < 0) continue;
      T t[V];
#pragma unroll
      for (int l = 0; l < V; ++l) t[l] = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (hit_x & (1u << j)) {
          const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(go + (col + oy * gs2 + j * gs3));
#pragma unroll
          for (int l = 0; l < V; ++l) t[l] = add_rn(t[l], mul_rn(wx[j], q.v[l]));
        }
      }
      // lo, where set, is row cur; hi is cur (lo = ia - 1, outside) or cur + 1.
      if (e.lo >= 0) {
#pragma unroll
        for (int l = 0; l < V; ++l) acc0[l] = add_rn(acc0[l], mul_rn(e.w_lo, t[l]));
      }
      if (e.hi == cur) {
#pragma unroll
        for (int l = 0; l < V; ++l) acc0[l] = add_rn(acc0[l], mul_rn(e.w_hi, t[l]));
      } else if (e.hi >= 0) {
#pragma unroll
        for (int l = 0; l < V; ++l) acc1[l] = add_rn(acc1[l], mul_rn(e.w_hi, t[l]));
      }
    }
    for (; cur < ib; ++cur) {
      Pack<T, V> s;
#pragma unroll
      for (int l = 0; l < V; ++l) s.v[l] = acc0[l], acc0[l] = acc1[l], acc1[l] = 0;
      *reinterpret_cast<Pack<T, V>*>(out + cur * row_pitch) = s;
    }
  }
}

template <typename T, int V16>
int launch(const Params& p, long long planes, int vec, dim3 block, cudaStream_t stream) {
  if (planes * p.n_bands >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(planes * p.n_bands), (p.w + block.y - 1) / block.y,
                  (p.cv + block.x - 1) / block.x);
  if (vec == 1) {
    upsample_bilinear_backward_band<T, 1><<<grid, block, 0, stream>>>(p);
  } else if (vec == V16) {
    upsample_bilinear_backward_band<T, V16><<<grid, block, 0, stream>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 2 float64. shape: N, C, H, W of the input, upsampled by kScale on both
// axes; go_stride: grad_out's strides in elements; plan: vector width, channels_last
// (0 / 1), block (x, y), band rows, as ops/upsample.py's k6_plan gives them. Returns a
// cudaError_t.
extern "C" int ted_upsample_bilinear_backward(const void* grad_out, void* grad_in, int dtype, const int* shape,
                                              const long long* go_stride, const int* plan, void* stream) {
  Params p{};
  p.grad_out = grad_out;
  p.grad_in = grad_in;
  const int n = shape[0], c = shape[1];
  p.h = shape[2], p.w = shape[3];
  p.go_batch = go_stride[0];
  for (int i = 0; i < 3; ++i) p.go_stride[i] = static_cast<int>(go_stride[i + 1]);
  const int vec = plan[0], channels_last = plan[1];
  const dim3 block(plan[2], plan[3]);
  p.band = plan[4];
  p.c_outer = channels_last ? 1 : c;
  p.c_inner = channels_last ? c : 1;
  p.cv = p.c_inner / vec;
  const long long planes = static_cast<long long>(n) * p.c_outer;
  if (planes == 0 || p.h == 0 || p.w == 0 || c == 0) return 0;
  if (vec < 1 || p.c_inner % vec != 0 || p.band < 1 || p.band > kMaxBand || block.x * block.y > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_bands = (p.h + p.band - 1) / p.band;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, 4>(p, planes, vec, block, s);
    case 2: return launch<double, 2>(p, planes, vec, block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
