// The decode step's MLP: out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces mic_tpu/ops/fused_mlp.py::fused_mlp (_kernel), used under
// MIC_TPU_EXPERIMENTAL=fused_mlp.  Rounding points, as the TPU kernel's: fc1
// sums in f32 and is rounded to bf16, the bf16 b1 added in bf16, then the
// activation rounded to bf16; fc2 sums in f32 over all of F, adds b2 (a bf16
// value) in f32, and rounds once to bf16.  The activations are those of
// nn/layers.py::ACTIVATIONS, in the order of ops/fused_mlp.py::_ACTIVATION_IDS:
// "gelu" is the erf gelu in f32 with erf from Abramowitz & Stegun 7.1.26 (the
// TPU kernel's own polynomial: Mosaic has no erf); the others round where
// their PyTorch form on a bf16 tensor does.  The TPU kernel adds fc2's F
// chunks into its f32 output in chunk order; here one tile sums all of F, so
// the two differ in f32 summation order only.
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// F = 4096) 17.2 GFLOP against 21 MB of weights and activations.  Design
// (the simple first version): two launches of gemm_tile.cuh's 64 x 64 WMMA
// tile, fc1 with the bias and activation in its epilogue writing the (N, F) bf16
// intermediate to device memory (8 MB at the flagship, written once and
// read once, mostly from L2), then fc2 with b2 in its epilogue.  The TPU
// kernel kept the intermediate on chip; this one does not yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using gemm::bf16;

// erf(z) by Abramowitz & Stegun 7.1.26, as mic_tpu/ops/fused_mlp.py::_erf
__device__ __forceinline__ float erf_as(float z) {
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-a * a);
  return z < 0.f ? -e : e;
}

enum Act { kGelu = 0, kGeluTanh = 1, kQuickGelu = 2, kRelu = 3, kSilu = 4 };

// act(x) of a bf16 value x, before its final rounding to bf16
template <int kAct>
__device__ __forceinline__ float activate(float x) {
  if (kAct == kGelu) return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
  if (kAct == kGeluTanh) {  // F.gelu(approximate="tanh")
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  if (kAct == kQuickGelu) {  // x * sigmoid(1.702 x), each op rounded to bf16
    const float z = gemm::bf16_round(1.702f * x);
    return x * gemm::bf16_round(1.f / (1.f + expf(-z)));
  }
  if (kAct == kRelu) return fmaxf(x, 0.f);
  return x / (1.f + expf(-x));  // F.silu
}

template <int kAct>
struct BiasAct {
  bf16* h;
  const bf16* b1;
  int f;

  __device__ __forceinline__ void operator()(const float* c, int row, int col) const {
    float v[8], bv[8];
    gemm::unpack8(b1 + col, bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = activate<kAct>(gemm::bf16_round(gemm::bf16_round(c[j]) + bv[j]));
    }
    gemm::pack8(v, h + static_cast<size_t>(row) * f + col);
  }
};

struct AddBias {
  bf16* out;
  const bf16* b2;
  int d;

  __device__ __forceinline__ void operator()(const float* c, int row, int col) const {
    float v[8], bv[8];
    gemm::unpack8(b2 + col, bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c[j] + bv[j];
    gemm::pack8(v, out + static_cast<size_t>(row) * d + col);
  }
};

template <int kAct>
__global__ void __launch_bounds__(gemm::kThreads)
fc1_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, bf16* __restrict__ h, int n, int d, int f) {
  __shared__ __align__(128) unsigned char smem[gemm::kSmemBytes];
  const int row0 = blockIdx.y * gemm::kBM;
  const gemm::LoadRows load{x, d, row0, n};
  const BiasAct<kAct> epi{h, b1, f};
  gemm::tile(load, w1, f, d, row0, blockIdx.x * gemm::kBN, n, smem, epi);
}

__global__ void __launch_bounds__(gemm::kThreads)
fc2_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
           bf16* __restrict__ out, int n, int d, int f) {
  __shared__ __align__(128) unsigned char smem[gemm::kSmemBytes];
  const int row0 = blockIdx.y * gemm::kBM;
  const gemm::LoadRows load{h, f, row0, n};
  const AddBias epi{out, b2, d};
  gemm::tile(load, w2, d, f, row0, blockIdx.x * gemm::kBN, n, smem, epi);
}

// fc1 with activation kAct, on `grid` blocks
template <int kAct>
cudaError_t launch_fc1(dim3 grid, cudaStream_t s, void* x, void* w1, void* b1, void* h, int n,
                       int d, int f) {
  fc1_act_kernel<kAct><<<grid, gemm::kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<bf16*>(h), n, d, f);
  return cudaGetLastError();
}

}  // namespace

// x (N, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,), h (N, F) scratch,
// out (N, D); all bf16.  act: an Act.
extern "C" int mic_fused_mlp_bf16(void* x, void* w1, void* b1, void* w2, void* b2, void* h,
                                  void* out, int n, int d, int f, int act, void* stream) {
  if (n < 1 || d < gemm::kBN || d % gemm::kBN || f < gemm::kBN || f % gemm::kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (n + gemm::kBM - 1) / gemm::kBM;
  const dim3 grid1(f / gemm::kBN, row_tiles);
  cudaError_t err;
  switch (act) {
    case kGelu: err = launch_fc1<kGelu>(grid1, s, x, w1, b1, h, n, d, f); break;
    case kGeluTanh: err = launch_fc1<kGeluTanh>(grid1, s, x, w1, b1, h, n, d, f); break;
    case kQuickGelu: err = launch_fc1<kQuickGelu>(grid1, s, x, w1, b1, h, n, d, f); break;
    case kRelu: err = launch_fc1<kRelu>(grid1, s, x, w1, b1, h, n, d, f); break;
    case kSilu: err = launch_fc1<kSilu>(grid1, s, x, w1, b1, h, n, d, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  fc2_kernel<<<dim3(d / gemm::kBN, row_tiles), gemm::kThreads, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), n, d, f);
  return static_cast<int>(cudaGetLastError());
}
