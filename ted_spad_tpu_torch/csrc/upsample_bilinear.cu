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
// Gather form, no atomics: one thread per input pixel (n, c, iy, ix). Along each axis
// the outputs o that read input i are those whose taps i0 = (int)src, i1 = i0 + (i0 <
// in - 1) name it, with src = scale * o and scale = (in - 1) / (out - 1) computed in the
// data's type as torch's forward computes them; their weight along the axis is
// (i0 == i ? 1 - lam : 0) + (i1 == i ? lam : 0), lam = src - i0. With out = 2 in they
// lie in [2 i - 3, 2 i + 4] (8 candidates, one of margin at each end). The thread sums
// the separable form in a fixed order:
//     grad_in[iy, ix] = sum over oy ascending of wy * (sum over ox ascending of wx * g[oy, ox])
// each product and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction),
// so the plain version (ops/upsample.py: upsample_bilinear_backward_reference), which
// adds the same masked products in the same order, is bit-equal to it.
//
// Layouts: grad_out is read through its own strides; grad_in is written dense, NCHW or
// channels_last (NHWC) as the input was, the threads walking it in that order.
//
// Bound: bytes. grad_out read once and grad_in written once: at the UNet's largest
// upsample (up4: 64 channels, 112^2 -> 224^2, float32) on the fa pretraining batch of 32
// frames 514 MB, 0.153 ms at 3.35 TB/s; a few dozen operations per input element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScale = 2;  // out = 2 in on both axes, the UNet's
constexpr int kTaps = 4 * kScale;  // candidate outputs per axis

struct Params {
  const void* grad_out;
  void* grad_in;
  long long n_in;  // N * C * H * W
  int c, h, w;
  long long go_stride[4];  // elements, (N, C, OH, OW)
  int channels_last;
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

// Index is the type of the element cursor: 32-bit where the tensor allows it (a 64-bit
// division costs dozens of instructions on the card). Each thread finds its column taps
// once, in registers, and not again for every row.
template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads) upsample_bilinear_backward_kernel(const Params p) {
  const T* go = static_cast<const T*>(p.grad_out);
  T* gi = static_cast<T*>(p.grad_in);
  const int oh = p.h * kScale, ow = p.w * kScale;
  // torch: (in - 1) / (out - 1) in the accumulate type.
  const T scale_y = static_cast<T>(p.h - 1) / static_cast<T>(oh - 1);
  const T scale_x = static_cast<T>(p.w - 1) / static_cast<T>(ow - 1);
  const Index n_in = static_cast<Index>(p.n_in);
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index lin = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; lin < n_in; lin += step) {
    Index r = lin;
    int n, c, y, x;
    if (p.channels_last) {
      c = static_cast<int>(r % p.c); r /= p.c;
      x = static_cast<int>(r % p.w); r /= p.w;
      y = static_cast<int>(r % p.h); r /= p.h;
    } else {
      x = static_cast<int>(r % p.w); r /= p.w;
      y = static_cast<int>(r % p.h); r /= p.h;
      c = static_cast<int>(r % p.c); r /= p.c;
    }
    n = static_cast<int>(r);
    const T* base = go + n * p.go_stride[0] + c * p.go_stride[1];
    const int y_lo = kScale * y - kScale - 1, x_lo = kScale * x - kScale - 1;
    T wx[kTaps];
    bool hit_x[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int ox = x_lo + j;
      hit_x[j] = ox >= 0 && ox < ow && tap(ox, x, p.w, scale_x, &wx[j]);
    }
    T acc = 0;
    for (int j = 0; j < kTaps; ++j) {
      const int oy = y_lo + j;
      T wy;
      if (oy < 0 || oy >= oh || !tap(oy, y, p.h, scale_y, &wy)) continue;
      const T* row = base + oy * p.go_stride[2];
      T t = 0;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        if (hit_x[k]) t = add_rn(t, mul_rn(wx[k], row[(x_lo + k) * p.go_stride[3]]));
      }
      acc = add_rn(acc, mul_rn(wy, t));
    }
    gi[lin] = acc;
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  long long blocks = (p.n_in + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16 * 64;  // a grid-stride loop beyond 16 waves of 8 blocks an SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  // The 32-bit cursor's lin + step stays below 2^32.
  if (p.n_in < (1LL << 31)) {
    upsample_bilinear_backward_kernel<T, unsigned><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  } else {
    upsample_bilinear_backward_kernel<T, long long><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 2 float64. shape: N, C, H, W of the input, upsampled by kScale on both
// axes; go_stride: grad_out's strides in elements. Returns a cudaError_t.
extern "C" int ted_upsample_bilinear_backward(const void* grad_out, void* grad_in, int dtype, const int* shape,
                                              const long long* go_stride, int channels_last, void* stream) {
  Params p{};
  p.grad_out = grad_out;
  p.grad_in = grad_in;
  p.c = shape[1], p.h = shape[2], p.w = shape[3];
  p.n_in = static_cast<long long>(shape[0]) * p.c * p.h * p.w;
  for (int i = 0; i < 4; ++i) p.go_stride[i] = go_stride[i];
  p.channels_last = channels_last;
  if (p.n_in == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 2: return launch<double>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
