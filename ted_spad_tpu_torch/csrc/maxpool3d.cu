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
// No atomics: each input element receives the gradients of the output windows that
// contain it where the forward's argmax (the flat index F.max_pool3d(return_indices=True)
// returns, within the unpadded (D, H, W) volume) names it, in ascending (od, oh, ow)
// order, from one thread, and is written once. float64 sums in float64; float32 and
// bf16 sum in float32 and round once. The plain version (ops/maxpool3d.py:
// max_pool3d_backward_reference) adds the same values in the same order, so the two
// are bit-equal.
//
// Bound: bytes. It must read grad_out and the int64 indices once and write grad_in
// once; at the adversarial step's stem pool (24 clips x 64 x 8 x 112 x 112 in, bf16,
// channels_last_3d) that is 494 MB, 0.147 ms at 3.35 TB/s. The adds are a few per
// element. The first form (one thread per element, its flat index split by four `%`
// and four `/` by runtime sizes, two more divisions per axis for the window ranges,
// 64-bit stride products per window, 2 bytes a thread) was bound by that integer work:
// 2.80 ms device time, 4.1x torch's atomic backward. Two forms replace it; the wrapper's
// plan (ops/maxpool3d.py: k5_plan) picks one per call.
//
// The owner form (windows that overlap in h or w but not in d, on channels_last_3d
// operands with channel stride 1: the stem's and InceptionI3d's 2a / 3a pools). A
// gather checks every window of every input element: at the stem ~347M lane-window
// compares against 18.6M outputs, issue-bound however the windows are fetched (from
// L1, 0.54 ms; staged in shared memory by cp.async, 0.46). So the work goes with the
// outputs. A block owns tile_h input rows of one (b, d) x all W x 32 channels, their
// float sums in shared memory; thread (c, s) owns channel c of a run of columns. It
// walks the outputs whose windows cover its elements in ascending (od, oh, ow) order,
// 8 at a time with all their loads in flight, reads each argmax's low word once,
// divides it by W with a multiply and a shift, and adds grad_out to the sum of the
// element it names where that element is its own: one thread an element, the plain
// version's order, no race. Then the block writes its rows out, 16 bytes a thread.
// 0.39 ms at the stem.
//
// The row form (everything else: no overlap, overlap in d, NCDHW, grad_out or indices
// without channel stride 1). A block holds rows (b, c_outer, d, h) of the dense
// grad_in: (b, d, h) with W x C elements in channels_last_3d (c_outer 1, c_inner C),
// (b, c, d, h) with W in NCDHW (c_outer C, c_inner 1). One thread per row computes its
// d and h window ranges, target (d H + h) W and 64-bit offsets into shared memory;
// thread (x, y) then takes channel vector x of column w, divides only by a
// compile-time stride (instances for 1 and 2) for the w range, and walks its windows
// 4 at a time with all their loads in flight, comparing each lane's index with the one
// target. 16-byte vectors (8 bf16, 4 float32, 2 float64, and their indices) where the
// layout allows (channels_last_3d, C a multiple of the width, grad_out and the indices
// with channel stride 1 and every other stride a multiple of it, 16-byte aligned); one
// element a thread, through the operands' strides, elsewhere: the generic path.
//
// Offsets within a sample are 32-bit (the wrapper refuses samples of 2^31 elements or
// more), since a 64-bit division is a called routine and 64-bit offsets carried through
// the loops spilled. Both launch bounds are named: with the block size alone ptxas
// spills a few bytes to reach an occupancy step, and the build refuses any spill.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 64;  // blockDim.z's limit
constexpr int kBatch = 4;     // windows whose loads are in flight together (the row form)
// Outputs whose loads are in flight together in the owner form: 8, 4 for float64 (whose
// 8 spills). On the card 6 took the stem pool from 0.39 to 0.46 ms.
template <typename T>
constexpr int kOwnerBatch = sizeof(T) == 8 ? 4 : 8;

// Strides in elements of (C, Do, Ho, Wo).
struct Strides {
  int c, d, h, w;
};

struct Params {
  const void* grad_out;
  const int64_t* idx;
  void* grad_in;
  int rows;              // B * c_outer * D * H, below 2^31 (the wrapper's limit)
  int c_outer, c_inner;  // (1, C) channels_last_3d, (C, 1) NCDHW
  int cv;                // c_inner / vector width
  int d, h, w;
  int od, oh, ow;
  int kd, kh, kw;
  int sd, sh, sw;
  int pd, ph, pw;
  // Strides in elements of (B, C, Do, Ho, Wo). A sample's span below 2^31 elements (the
  // wrapper's limit) keeps every offset but the batch's in 32 bits.
  long long go_batch, ix_batch;
  Strides go_stride, ix_stride;
  // The owner form: input rows a block, their tiles along H, channels a chunk, columns a
  // thread, and h = r / W as (r w_magic) >> w_shift.
  int tile_h, n_tiles, chunk, seg_w;
  unsigned w_magic;
  int w_shift;
};

// What a row's threads share, computed once.
struct Row {
  long long gi;      // grad_in offset of (row, w 0, channel 0)
  long long go, ix;  // grad_out / index offsets of (b, c_outer, od = d0, oh = h0, ow 0)
  long long target;  // (d H + h) W
  int d0, d1, h0, h1;
};

// An offset within a sample, in 32 bits: channel c and a window's (od - d0, oh - h0, ow)
// through the strides s.
__device__ __forceinline__ int offset(const Strides s, int c, int dd, int dh, int ow) {
  return c * s.c + dd * s.d + dh * s.h + ow * s.w;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ __nv_bfloat16 narrow(float v, const __nv_bfloat16*) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float narrow(float v, const float*) { return v; }
__device__ __forceinline__ double narrow(double v, const double*) { return v; }

// The outputs along one axis whose window holds input position i: [lo, hi]; S > 0 is
// the stride known at compile time, S == 0 takes the runtime s.
template <int S>
__device__ __forceinline__ void window_range(int i, int pad, int k, int s, int n_out, int* lo, int* hi) {
  const unsigned step = S > 0 ? S : s;
  const int first = i + pad - k + 1;
  *lo = first <= 0 ? 0 : static_cast<int>((static_cast<unsigned>(first) + step - 1) / step);
  const int last = static_cast<int>(static_cast<unsigned>(i + pad) / step);
  *hi = last < n_out - 1 ? last : n_out - 1;
}

// Which of the V int64 indices from 16-byte-aligned p (V == 1: one 8-byte load) equal
// target: bit l for lane l. Each 16-byte pair is compared as it arrives, so no more
// than two indices are held at once.
template <int V>
__device__ __forceinline__ unsigned hits(const int64_t* p, long long target) {
  if constexpr (V == 1) {
    return __ldg(reinterpret_cast<const long long*>(p)) == target;
  } else {
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      const longlong2 q = __ldg(reinterpret_cast<const longlong2*>(p) + i / 2);
      bits |= (q.x == target ? 1u : 0u) << i | (q.y == target ? 1u : 0u) << (i + 1);
    }
    return bits;
  }
}

// Both launch bounds named: with the block size alone, ptxas spills a few bytes to reach
// an occupancy step (48 registers), and the build refuses any spill.
template <typename T, typename Acc, int V, int SW>
__global__ void __launch_bounds__(256, 3) maxpool3d_backward_rows(const Params p) {
  __shared__ Row rows[kMaxRows];
  const int z = threadIdx.z;
  // 32-bit: a 64-bit division is a called routine, which spills.
  const unsigned r = blockIdx.x * blockDim.z + z;
  if (threadIdx.x == 0 && threadIdx.y == 0 && r < static_cast<unsigned>(p.rows)) {
    unsigned q = r;
    const int h = static_cast<int>(q % static_cast<unsigned>(p.h)); q /= static_cast<unsigned>(p.h);
    const int d = static_cast<int>(q % static_cast<unsigned>(p.d)); q /= static_cast<unsigned>(p.d);
    const int co = static_cast<int>(q % static_cast<unsigned>(p.c_outer));
    const long long b = q / static_cast<unsigned>(p.c_outer);
    Row row;
    window_range<0>(d, p.pd, p.kd, p.sd, p.od, &row.d0, &row.d1);
    window_range<0>(h, p.ph, p.kh, p.sh, p.oh, &row.h0, &row.h1);
    row.target = (static_cast<long long>(d) * p.h + h) * p.w;
    row.gi = static_cast<long long>(r) * p.w * p.c_inner;
    row.go = b * p.go_batch + offset(p.go_stride, co, row.d0, row.h0, 0);
    row.ix = b * p.ix_batch + offset(p.ix_stride, co, row.d0, row.h0, 0);
    rows[z] = row;
  }
  __syncthreads();
  const int w = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= static_cast<unsigned>(p.rows) || w >= p.w) return;
  const Row row = rows[z];
  int w0, w1;
  window_range<SW>(w, p.pw, p.kw, p.sw, p.ow, &w0, &w1);
  const long long target = row.target + w;
  const T* go = static_cast<const T*>(p.grad_out) + row.go;
  const int64_t* ix = p.idx + row.ix;
  T* gi = static_cast<T*>(p.grad_in) + row.gi + w * p.c_inner;
  const int nd = row.d1 - row.d0 + 1, nh = row.h1 - row.h0 + 1, nw = w1 - w0 + 1;
  const int n = nd > 0 && nh > 0 && nw > 0 ? nd * nh * nw : 0;  // windows that hold (d, h, w)
  for (int cv = threadIdx.x; cv < p.cv; cv += blockDim.x) {
    Acc acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0;
    // The windows in ascending (od, oh, ow) order, an odometer over (dd, dh, ow), kBatch
    // at a time: every load of a batch (indices and grad_out, the latter whether or not
    // a lane names it) is issued before the first add. Vector widths above 1 come with
    // channel strides of 1 (the plan's condition).
    int dd = 0, dh = 0, ow = w0;
    for (int k = 0; k < n; k += kBatch) {
      unsigned hit[kBatch];
      Pack<T, V> g[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        hit[u] = 0;
        if (k + u < n) {
          hit[u] = hits<V>(ix + offset(p.ix_stride, cv * V, dd, dh, ow), target);
          g[u] = *reinterpret_cast<const Pack<T, V>*>(go + offset(p.go_stride, cv * V, dd, dh, ow));
          if (++ow > w1) {
            ow = w0;
            if (++dh == nh) dh = 0, ++dd;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int l = 0; l < V; ++l) {
          if (hit[u] & (1u << l)) acc[l] = acc[l] + static_cast<Acc>(widen(g[u].v[l]));
        }
      }
    }
    Pack<T, V> out;
#pragma unroll
    for (int l = 0; l < V; ++l) out.v[l] = narrow(acc[l], static_cast<const T*>(nullptr));
    *reinterpret_cast<Pack<T, V>*>(gi + cv * V) = out;
  }
}

// The owner form, for channels_last_3d grad_in whose grad_out and indices have channel
// stride 1 (any window). A block owns tile_h input rows of one (b, d) x all W x one chunk
// of channels, their float sums in shared memory. Thread (c, s) owns channel c of the
// columns [s seg_w, (s + 1) seg_w) of those rows: it walks the outputs whose windows
// cover them in ascending (od, oh, ow) order, reads each one's argmax (its low 32 bits:
// indices lie below 2^31, the wrapper's limit) and grad_out once, and where the argmax
// is one of its own elements adds grad_out to that element's sum. An element so
// receives its windows' gradients in ascending order from one thread, as the plain
// version adds them, with no race; the work goes with the outputs (a few visits each)
// rather than with the input elements' windows. Then the block writes its rows out,
// V channels a thread.
// Bounds (256, 3): 80 registers; under (256, 4)'s 64, a batch of 8 spills 4 bytes.
template <typename T, typename Acc, int V>
__global__ void __launch_bounds__(256, 3) maxpool3d_backward_owner(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* acc = reinterpret_cast<Acc*>(smem);  // [tile_h][W][chunk]
  unsigned q = blockIdx.x;  // (b, d, tile)
  const int tile = static_cast<int>(q % static_cast<unsigned>(p.n_tiles));
  q /= static_cast<unsigned>(p.n_tiles);
  const int d = static_cast<int>(q % static_cast<unsigned>(p.d));
  const long long b = q / static_cast<unsigned>(p.d);
  const int ha = tile * p.tile_h, hb = ha + p.tile_h < p.h ? ha + p.tile_h : p.h;
  const int c0 = blockIdx.y * p.chunk;
  const int cc = p.chunk < p.c_inner - c0 ? p.chunk : p.c_inner - c0;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y, n_threads = blockDim.x * blockDim.y;
  const int cells = (hb - ha) * p.w;
  for (int i = tid; i < cells * p.chunk; i += n_threads) acc[i] = 0;
  __syncthreads();
  const int c = threadIdx.x;
  const int wa = threadIdx.y * p.seg_w, wb = wa + p.seg_w < p.w ? wa + p.seg_w : p.w;
  if (c < cc && wa < wb) {
    int d0, d1, h0, h1, w0, w1, unused;
    window_range<0>(d, p.pd, p.kd, p.sd, p.od, &d0, &d1);
    window_range<0>(ha, p.ph, p.kh, p.sh, p.oh, &h0, &unused);
    window_range<0>(hb - 1, p.ph, p.kh, p.sh, p.oh, &unused, &h1);
    window_range<0>(wa, p.pw, p.kw, p.sw, p.ow, &w0, &unused);
    window_range<0>(wb - 1, p.pw, p.kw, p.sw, p.ow, &unused, &w1);
    const int* ix = reinterpret_cast<const int*>(p.idx + b * p.ix_batch + offset(p.ix_stride, c0 + c, 0, 0, 0));
    const T* go = static_cast<const T*>(p.grad_out) + b * p.go_batch + offset(p.go_stride, c0 + c, 0, 0, 0);
    const int plane = p.h * p.w, first = d * plane;  // the argmax of an element of this d: first + h W + w
    for (int od = d0; od <= d1; ++od) {
      for (int oh = h0; oh <= h1; ++oh) {
        const int ix_row = od * p.ix_stride.d + oh * p.ix_stride.h, go_row = od * p.go_stride.d + oh * p.go_stride.h;
        for (int ow = w0; ow <= w1; ow += kOwnerBatch<T>) {
          // kOwnerBatch outputs' loads in flight together, then their adds in order.
          unsigned r[kOwnerBatch<T>];
          T g[kOwnerBatch<T>];
#pragma unroll
          for (int u = 0; u < kOwnerBatch<T>; ++u) {
            r[u] = ~0u;
            if (ow + u <= w1) {
              r[u] = static_cast<unsigned>(__ldg(ix + 2 * (ix_row + (ow + u) * p.ix_stride.w)) - first);
              g[u] = go[go_row + (ow + u) * p.go_stride.w];
            }
          }
#pragma unroll
          for (int u = 0; u < kOwnerBatch<T>; ++u) {
            if (r[u] < static_cast<unsigned>(plane)) {
              // h = r / W by the magic number: exact for r below 2^31.
              const unsigned h = static_cast<unsigned>((static_cast<unsigned long long>(r[u]) * p.w_magic) >> p.w_shift);
              const unsigned w = r[u] - h * p.w;
              if (h - ha < static_cast<unsigned>(hb - ha) && w - wa < static_cast<unsigned>(wb - wa)) {
                Acc& sum = acc[((h - ha) * p.w + w) * p.chunk + c];
                sum = sum + static_cast<Acc>(widen(g[u]));
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  // The rows out, dense channels_last_3d: V channels a thread, a cell's vectors together.
  T* gi = static_cast<T*>(p.grad_in) + ((b * p.d + d) * p.h + ha) * p.w * p.c_inner + c0;
  const int vectors = p.chunk / V;
  const int cv = tid % vectors;
  if (tid < n_threads / vectors * vectors && cv * V < cc) {
    for (int cell = tid / vectors; cell < cells; cell += n_threads / vectors) {
      Pack<T, V> out;
#pragma unroll
      for (int l = 0; l < V; ++l) out.v[l] = narrow(acc[cell * p.chunk + cv * V + l], static_cast<const T*>(nullptr));
      *reinterpret_cast<Pack<T, V>*>(gi + static_cast<long long>(cell) * p.c_inner + cv * V) = out;
    }
  }
}

template <typename T, typename Acc, int V>
int launch_owner(const Params& p, dim3 block, cudaStream_t stream) {
  const int bytes = p.tile_h * p.w * p.chunk * static_cast<int>(sizeof(Acc));
  const auto kernel = maxpool3d_backward_owner<T, Acc, V>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(static_cast<unsigned>(p.rows / p.h * p.n_tiles), (p.c_inner + p.chunk - 1) / p.chunk);
  kernel<<<grid, block, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc, int V>
int launch_width(const Params& p, dim3 block, cudaStream_t stream) {
  if (p.tile_h > 0) return launch_owner<T, Acc, V>(p, block, stream);
  const dim3 grid((p.rows + block.z - 1) / block.z, (p.w + block.y - 1) / block.y);
  switch (p.sw) {
    case 1: maxpool3d_backward_rows<T, Acc, V, 1><<<grid, block, 0, stream>>>(p); break;
    case 2: maxpool3d_backward_rows<T, Acc, V, 2><<<grid, block, 0, stream>>>(p); break;
    default: maxpool3d_backward_rows<T, Acc, V, 0><<<grid, block, 0, stream>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// V16: the width of a 16-byte vector of T.
template <typename T, typename Acc, int V16>
int launch(const Params& p, int vec, dim3 block, cudaStream_t stream) {
  if (vec == 1) return launch_width<T, Acc, 1>(p, block, stream);
  if (vec == V16) return launch_width<T, Acc, V16>(p, block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float64. shape: B, C, D, H, W, Do, Ho, Wo; window,
// strides, padding: (d, h, w) each; strides of grad_out and the indices in elements;
// plan: vector width, channels_last_3d (0 / 1), block (x, y, z), and for the owner form
// (else 0) its input rows, channel chunk and columns a thread, as ops/maxpool3d.py's
// k5_plan gives them. Returns a cudaError_t.
extern "C" int ted_maxpool3d_backward(const void* grad_out, const int64_t* idx, void* grad_in, int dtype,
                                      const int* shape, const int* window, const int* strides,
                                      const int* padding, const long long* go_stride,
                                      const long long* idx_stride, const int* plan, void* stream) {
  Params p{};
  p.grad_out = grad_out;
  p.idx = idx;
  p.grad_in = grad_in;
  const int b = shape[0], c = shape[1];
  p.d = shape[2], p.h = shape[3], p.w = shape[4];
  p.od = shape[5], p.oh = shape[6], p.ow = shape[7];
  p.kd = window[0], p.kh = window[1], p.kw = window[2];
  p.sd = strides[0], p.sh = strides[1], p.sw = strides[2];
  p.pd = padding[0], p.ph = padding[1], p.pw = padding[2];
  p.go_batch = go_stride[0];
  p.ix_batch = idx_stride[0];
  p.go_stride = {static_cast<int>(go_stride[1]), static_cast<int>(go_stride[2]), static_cast<int>(go_stride[3]),
                 static_cast<int>(go_stride[4])};
  p.ix_stride = {static_cast<int>(idx_stride[1]), static_cast<int>(idx_stride[2]),
                 static_cast<int>(idx_stride[3]), static_cast<int>(idx_stride[4])};
  const int vec = plan[0], channels_last = plan[1];
  const dim3 block(plan[2], plan[3], plan[4]);
  p.c_outer = channels_last ? 1 : c;
  p.c_inner = channels_last ? c : 1;
  p.cv = p.c_inner / vec;
  const long long rows = static_cast<long long>(b) * p.c_outer * p.d * p.h;
  if (rows == 0 || p.w == 0 || c == 0) return 0;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.rows = static_cast<int>(rows);
  p.tile_h = plan[5], p.chunk = plan[6], p.seg_w = plan[7];
  // r / W == (r m) >> (31 + l) for r below 2^31: m = ceil(2^(31 + l) / W), l = ceil(log2 W),
  // below 2^32.
  p.w_shift = 31;
  while ((1LL << (p.w_shift - 31)) < p.w) ++p.w_shift;
  p.w_magic = static_cast<unsigned>(((1ULL << p.w_shift) + p.w - 1) / p.w);
  if (p.sd < 1 || p.sh < 1 || p.sw < 1 || vec < 1 || p.c_inner % vec != 0 || block.z > kMaxRows ||
      block.x * block.y * block.z > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.tile_h > 0) {  // channels_last_3d, channel-stride-1 operands, a thread a (channel, columns)
    if (!channels_last || go_stride[1] != 1 || idx_stride[1] != 1 || p.chunk % vec != 0 ||
        static_cast<int>(block.x) != p.chunk || block.y * p.seg_w < static_cast<unsigned>(p.w) ||
        p.tile_h * p.w * p.chunk * 8 > 227 * 1024 || static_cast<long long>(p.d) * p.h * p.w >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.n_tiles = (p.h + p.tile_h - 1) / p.tile_h;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float, 4>(p, vec, block, s);
    case 1: return launch<__nv_bfloat16, float, 8>(p, vec, block, s);
    case 2: return launch<double, double, 2>(p, vec, block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
