// K5: the backward of a 3D max pool, deterministic, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package pools through XLA's reduce_window (flax
// `nn.max_pool`: ted_spad_tpu/models/layers.py:84-100, ted_spad_tpu/models/mvit.py:151)
// and its gradient is XLA's select_and_scatter, which on a TPU gives the same bits on
// every run. Torch's CUDA backward (`max_pool3d_with_indices_backward_cuda`) scatters
// each output's gradient into the input with atomics, so where windows overlap (the
// I3Res50's (2,3,3)/(2,2,2) stem pool, InceptionI3d's SAME pools, MViTv2's skip pools)
// the order of the adds, and so the last bits of the gradient, changes from run to run.
//
// Gather form, no atomics: one thread per input element. It visits the output windows
// that contain the element in ascending (od, oh, ow) order and adds grad_out where the
// forward's argmax (the flat index F.max_pool3d(return_indices=True) returns, within
// the unpadded (D, H, W) volume) names this element; then it writes its sum once.
// float64 sums in float64; float32 and bf16 sum in float32 and round once. The plain
// version (ops/maxpool3d.py: max_pool3d_backward_reference) adds the same values in the
// same order, so the two are bit-equal.
//
// Layouts: grad_out and the indices are read through their own strides (any layout);
// grad_in is written dense, NCDHW or channels_last_3d (NDHWC) as the input was, and the
// threads walk it in that order, so the stores coalesce and, for channels_last_3d, so do
// the reads of grad_out and the indices.
//
// Bound: bytes. It must read grad_out and the int64 indices once and write grad_in
// once; at the adversarial step's stem pool (24 clips x 64 x 8 x 112 x 112 in, bf16)
// that is 494 MB, 0.147 ms at 3.35 TB/s. The adds are a few per element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* grad_out;
  const int64_t* idx;
  void* grad_in;
  long long n_in;  // B * C * D * H * W
  int c, d, h, w;
  int od, oh, ow;
  int kd, kh, kw;
  int sd, sh, sw;
  int pd, ph, pw;
  long long go_stride[5];  // elements, (B, C, Do, Ho, Wo)
  long long idx_stride[5];
  int channels_last;  // grad_in NDHWC
};

__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// The outputs along one axis whose window holds input position i: [lo, hi].
__device__ __forceinline__ void window_range(int i, int pad, int k, int s, int n_out, int* lo, int* hi) {
  const int first = i + pad - k + 1;
  *lo = first <= 0 ? 0 : (first + s - 1) / s;
  const int last = (i + pad) / s;
  *hi = last < n_out - 1 ? last : n_out - 1;
}

// Index is the type of the element cursor: 32-bit where the tensor allows it, since a
// 64-bit division costs dozens of instructions on the card (the first form, 64-bit
// throughout, took 3.23 ms at the stem pool against torch's 0.69).
template <typename T, typename Acc, typename Index>
__global__ void __launch_bounds__(kThreads) maxpool3d_backward_kernel(const Params p) {
  const T* go = static_cast<const T*>(p.grad_out);
  T* gi = static_cast<T*>(p.grad_in);
  const Index n_in = static_cast<Index>(p.n_in);
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index lin = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; lin < n_in; lin += step) {
    Index r = lin;
    int b, c, d, h, w;
    if (p.channels_last) {
      c = static_cast<int>(r % p.c); r /= p.c;
      w = static_cast<int>(r % p.w); r /= p.w;
      h = static_cast<int>(r % p.h); r /= p.h;
      d = static_cast<int>(r % p.d); r /= p.d;
    } else {
      w = static_cast<int>(r % p.w); r /= p.w;
      h = static_cast<int>(r % p.h); r /= p.h;
      d = static_cast<int>(r % p.d); r /= p.d;
      c = static_cast<int>(r % p.c); r /= p.c;
    }
    b = static_cast<int>(r);
    int d0, d1, h0, h1, w0, w1;
    window_range(d, p.pd, p.kd, p.sd, p.od, &d0, &d1);
    window_range(h, p.ph, p.kh, p.sh, p.oh, &h0, &h1);
    window_range(w, p.pw, p.kw, p.sw, p.ow, &w0, &w1);
    const int64_t target = (static_cast<int64_t>(d) * p.h + h) * p.w + w;
    const long long go_bc = b * p.go_stride[0] + c * p.go_stride[1];
    const long long ix_bc = b * p.idx_stride[0] + c * p.idx_stride[1];
    Acc acc = 0;
    for (int od = d0; od <= d1; ++od) {
      for (int oh = h0; oh <= h1; ++oh) {
        for (int ow = w0; ow <= w1; ++ow) {
          const long long ix = ix_bc + od * p.idx_stride[2] + oh * p.idx_stride[3] + ow * p.idx_stride[4];
          if (p.idx[ix] == target) {
            acc = acc + static_cast<Acc>(
                load(go + go_bc + od * p.go_stride[2] + oh * p.go_stride[3] + ow * p.go_stride[4]));
          }
        }
      }
    }
    store(gi + lin, acc);
  }
}

template <typename T, typename Acc>
int launch(const Params& p, cudaStream_t stream) {
  long long blocks = (p.n_in + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16 * 64;  // a grid-stride loop beyond 16 waves of 8 blocks an SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  // The 32-bit cursor's lin + step stays below 2^32.
  if (p.n_in < (1LL << 31)) {
    maxpool3d_backward_kernel<T, Acc, unsigned><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  } else {
    maxpool3d_backward_kernel<T, Acc, long long><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float64. shape: B, C, D, H, W, Do, Ho, Wo; window,
// strides, padding: (d, h, w) each; strides of grad_out and the indices in elements.
// Returns a cudaError_t.
extern "C" int ted_maxpool3d_backward(const void* grad_out, const int64_t* idx, void* grad_in, int dtype,
                                      const int* shape, const int* window, const int* strides,
                                      const int* padding, const long long* go_stride,
                                      const long long* idx_stride, int channels_last, void* stream) {
  Params p{};
  p.grad_out = grad_out;
  p.idx = idx;
  p.grad_in = grad_in;
  p.c = shape[1], p.d = shape[2], p.h = shape[3], p.w = shape[4];
  p.od = shape[5], p.oh = shape[6], p.ow = shape[7];
  p.n_in = static_cast<long long>(shape[0]) * p.c * p.d * p.h * p.w;
  p.kd = window[0], p.kh = window[1], p.kw = window[2];
  p.sd = strides[0], p.sh = strides[1], p.sw = strides[2];
  p.pd = padding[0], p.ph = padding[1], p.pw = padding[2];
  for (int i = 0; i < 5; ++i) {
    p.go_stride[i] = go_stride[i];
    p.idx_stride[i] = idx_stride[i];
  }
  p.channels_last = channels_last;
  if (p.n_in == 0) return 0;
  if (p.sd < 1 || p.sh < 1 || p.sw < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float>(p, s);
    case 1: return launch<__nv_bfloat16, float>(p, s);
    case 2: return launch<double, double>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
