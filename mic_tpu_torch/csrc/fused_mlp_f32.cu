// The decode step's MLP on a float32 model: out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces mic_tpu/ops/fused_mlp.py::fused_mlp (_kernel) at float32, the
// decode step's fc1 -> activation -> fc2 under MIC_TPU_EXPERIMENTAL=fused_mlp
// on the default float32 model.  mic_tpu's kernel rounds fc1's sum and the
// activation to x's dtype, which at float32 round nothing: fc1 summed in
// f32, b1 added, the activation in f32 ("gelu": the erf gelu with erf from
// Abramowitz & Stegun 7.1.26, as mic_tpu's _gelu_erf, by expf and a true
// division), then fc2 summed in f32 and b2 added.  Nothing is rounded to
// bf16 and no product runs in TF32 alone.
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// F = 4096) 2 x 2 N D F = 17.2 GFLOP at the 165 TFLOP/s of float32-accurate
// tensor-core products, 0.104 ms; bytes at small N (N = 32: the 33.6 MB of
// float32 weights, 0.010 ms).
// Design: row 15 f32's tile (csrc/tf32x3_mma.cuh) for both products, three
// TF32 products a term on mma.sync.m16n8k8, whose fragments come from
// shared memory in any layout, so W1 (D, F) and W2 (F, D) are read as
// stored:
//   - a 128 x 96 output tile a block of eight warps over 16-deep slices
//     double-buffered in shared memory, the next slice loaded into
//     registers while the current one's products run, each slice summed
//     into the running sums by FADDs;
//   - fc1 finishes bias + activation on the accumulators and writes the
//     (N, F) f32 intermediate h; fc2 reads it as its A operand and finishes
//     the bias;
//   - where a product's tiles leave SMs idle (N = 32: fc1 43 tiles, fc2 11)
//     its depth is cut into splits of whole slices
//     (ops/ln_gemm.py::ln_splits_f32), their f32 partials summed in split
//     order with the bias (and fc1's activation) by a second kernel.
// Rows past N are read as zeros and never written; W's columns past the
// output width are read as zeros and never written.  Every sum has one
// fixed order: reruns are bit-equal.  An FFMA tile was not tried: row 15
// f32's lost to its plain version (PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3_mma.cuh"

namespace {
namespace mlp_f32 {

using namespace tf32x3_mma;

enum Act { kGelu = 0, kGeluTanh = 1, kQuickGelu = 2, kRelu = 3, kSilu = 4 };
constexpr int kNone = -1;  // fc2: no activation

// erf(z) by Abramowitz & Stegun 7.1.26, as mic_tpu/ops/fused_mlp.py::_erf
// and ops/fused_mlp.py::gelu_erf compute it in f32
__device__ __forceinline__ float erf_as(float z) {
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-a * a);
  return z < 0.f ? -e : e;
}

// fc1's activation kAct of x = sum + b1, in f32 (kNone: fc2's x itself).
// The activation is a template argument, as in csrc/fused_mlp.cu.
template <int kAct>
struct Activation {
  __device__ __forceinline__ float operator()(float x) const {
    if constexpr (kAct == kGelu) {
      return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
    } else if constexpr (kAct == kGeluTanh) {  // F.gelu(approximate="tanh")
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(inner));
    } else if constexpr (kAct == kQuickGelu) {  // x * sigmoid(1.702 x)
      return x * (1.f / (1.f + expf(-1.702f * x)));
    } else if constexpr (kAct == kRelu) {
      return fmaxf(x, 0.f);
    } else if constexpr (kAct == kSilu) {
      return x / (1.f + expf(-x));  // F.silu
    } else {
      return x;
    }
  }
};

struct Args {
  const float* a;     // (n, depth)
  const float* w;     // (depth, cols)
  const float* bias;  // (cols,)
  float* part;        // (splits, n, cols) where split, else unread
  float* out;         // (n, cols)
  int n, depth, cols;
};

template <int kAct>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  __shared__ __align__(16) float as[2][kRows][kAPitch];  // A, K-major
  __shared__ __align__(16) float ws[2][kDepth][kBPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  int s0, s1;
  split_range(a.depth / kDepth, s0, s1);

  // A row ar's eight columns ac.. of a slice
  const int ar = tid >> 1;
  const int ac = 8 * (tid & 1);
  const bool a_live = m0 + ar < a.n;
  const float* arow = a.a + static_cast<size_t>(a_live ? m0 + ar : 0) * a.depth + ac;

  Acc acc;
  zero(acc);
  walk<float4[2]>(
      acc, a.w, a.depth, c0, a.cols, ws, s0, s1,
      [&](int s, float4 (&av)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          av[h] = a_live ? *reinterpret_cast<const float4*>(arow + s * kDepth + 4 * h)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      },
      [&](int buf, const float4 (&av)[2]) {
        *reinterpret_cast<float4*>(&as[buf][ar][ac]) = av[0];
        *reinterpret_cast<float4*>(&as[buf][ar][ac + 4]) = av[1];
      },
      [&](int buf, int m, int k) { return as[buf][m][k]; });

  const bool split_z = gridDim.z > 1;
  const Activation<kAct> act{};
  for_each_pair(acc, m0, c0, a.n, a.cols, warp & 1, warp >> 1, lane,
                [&](int row, int col, float2 v) {
    const size_t at = static_cast<size_t>(row) * a.cols + col;
    if (split_z) {
      float* part = a.part + static_cast<size_t>(blockIdx.z) * a.n * a.cols;
      *reinterpret_cast<float2*>(part + at) = v;
    } else {
      const float2 b = *reinterpret_cast<const float2*>(a.bias + col);
      v.x = act(v.x + b.x);
      v.y = act(v.y + b.y);
      *reinterpret_cast<float2*>(a.out + at) = v;
    }
  });
}

// One product, (n, depth) a @ (depth, cols) w, finished with kAct into out,
// its depth cut into `splits` where splits > 1 (the partials then added in
// split order and finished by tf32x3_mma::split_sum_kernel).
template <int kAct>
cudaError_t product(const Args& a, int splits, cudaStream_t s) {
  const dim3 grid((a.cols + kCols - 1) / kCols, (a.n + kRows - 1) / kRows, splits);
  gemm_kernel<kAct><<<grid, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return split_sum(a.part, splits, static_cast<size_t>(a.n) * a.cols,
                   BiasEpilogue<Activation<kAct>>{a.bias, a.out, a.cols}, s);
}

// fc1 with activation kAct into h, then fc2 into out.
template <int kAct>
cudaError_t mlp(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, float* h, float* part, float* out, int n, int d, int f,
                int splits1, int splits2, cudaStream_t s) {
  const cudaError_t err = product<kAct>(Args{x, w1, b1, part, h, n, d, f}, splits1, s);
  if (err != cudaSuccess) return err;
  return product<kNone>(Args{h, w2, b2, part, out, n, f, d}, splits2, s);
}

}  // namespace mlp_f32
}  // namespace

// x (N, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,), out (N, D), all float32;
// h (N, F) float32 scratch for the intermediate; part float32 scratch of
// max(splits1 F, splits2 D) N values where either split count exceeds 1
// (else unread).  act: an Act; splits1 and splits2 cut fc1's D / 16 and
// fc2's F / 16 slices (ops/ln_gemm.py::ln_splits_f32).
extern "C" int mic_fused_mlp_f32(void* x, void* w1, void* b1, void* w2, void* b2, void* h,
                                 void* part, void* out, int n, int d, int f, int act,
                                 int splits1, int splits2, void* stream) {
  using namespace mlp_f32;
  if (n < 1 || d < 64 || f < 64 || d % 64 || f % 64 || splits1 < 1 || splits2 < 1 ||
      splits1 > d / kDepth || splits2 > f / kDepth || splits1 > 65535 || splits2 > 65535 ||
      (n + kRows - 1) / kRows > 65535 || (part == nullptr && (splits1 > 1 || splits2 > 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* hf = static_cast<float*>(h);
  auto* pf = static_cast<float*>(part);
  auto* of = static_cast<float*>(out);
  cudaError_t err;
  switch (act) {
    case kGelu:
      err = mlp<kGelu>(xf, w1f, b1f, w2f, b2f, hf, pf, of, n, d, f, splits1, splits2, s);
      break;
    case kGeluTanh:
      err = mlp<kGeluTanh>(xf, w1f, b1f, w2f, b2f, hf, pf, of, n, d, f, splits1, splits2, s);
      break;
    case kQuickGelu:
      err = mlp<kQuickGelu>(xf, w1f, b1f, w2f, b2f, hf, pf, of, n, d, f, splits1, splits2, s);
      break;
    case kRelu:
      err = mlp<kRelu>(xf, w1f, b1f, w2f, b2f, hf, pf, of, n, d, f, splits1, splits2, s);
      break;
    case kSilu:
      err = mlp<kSilu>(xf, w1f, b1f, w2f, b2f, hf, pf, of, n, d, f, splits1, splits2, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
