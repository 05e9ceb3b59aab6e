// The decode step's MLP: out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces mic_tpu/ops/fused_mlp.py::fused_mlp (_kernel), used under
// MIC_TPU_EXPERIMENTAL=fused_mlp.  Rounding points, as the TPU kernel's: fc1
// sums in f32 and is rounded to bf16, the bf16 b1 added in bf16, then the
// activation rounded to bf16; fc2 sums in f32 over all of F, adds b2 (a bf16
// value) in f32, and rounds once to bf16.  The activations are those of
// nn/layers.py::ACTIVATIONS, in the order of ops/fused_mlp.py::_ACTIVATION_IDS:
// "gelu" is the erf gelu in f32 with erf from Abramowitz & Stegun 7.1.26 (the
// TPU kernel's own polynomial: Mosaic has no erf; its reciprocal and exp
// here by the fast intrinsics __fdividef and __expf, within 2 ulp each,
// which moves a bf16 h by one ulp at most where the f32 value lies that
// close to a rounding boundary); the others round where
// their PyTorch form on a bf16 tensor does.  The TPU kernel adds fc2's
// 512-wide F chunks into its f32 output in chunk order; here a product's
// depth is cut into splits of whole 64-deep slices, each summed in one
// order and the splits added in split order, so the two differ in f32
// summation order only, and reruns are bit-equal.
//
// Bound: operations at the flagship step (N = 1024 rows, D = 1024, F = 4096:
// 17.2 GFLOP against 21 MB of weights and activations, 0.0174 ms); bytes at
// small N (N = 32: 16.8 MB of weights, 0.0051 ms).  Design: both products
// on gemm_wgmma.cuh's 128 x 256 tile (m64n256k16 wgmma, x or h read
// K-major and W1 or W2 read MN-major as stored, both by TMA through a
// four-slot ring, one product group in flight; 0.62 us a 64-deep slice a
// block at the flagship, near the tensor cores' 0.56).  The wrapper
// (ops/fused_mlp.py::mlp_splits) cuts a product's depth into splits where
// its output tiles leave SMs idle: fc1 at N = 1024 is 8 x 16 tiles, one
// wave, unsplit; fc2 is 8 x 4 tiles of 4 splits; at N = 32 (one row tile)
// fc1 runs 16 x 8 and fc2 4 x 33.  An unsplit tile is staged in shared
// memory and finished (bias, fc1's activation, the bf16 rounding) in
// 16-byte runs of the output; a split one writes f32 partials, (splits, N,
// cols), that gemm_wgmma.cuh's split_sum_kernel sums in split order.  The
// (N, F) bf16 intermediate goes through device memory (8 MB at the
// flagship, written once and read once, mostly from L2): keeping it on chip
// would need fc2's 1024-wide output, 512 KB of f32 per 128 rows, outside
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// erf(z) by Abramowitz & Stegun 7.1.26, as mic_tpu/ops/fused_mlp.py::_erf
__device__ __forceinline__ float erf_as(float z) {
  const float a = fabsf(z);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * __expf(-a * a);
  return z < 0.f ? -e : e;
}

enum Act { kGelu = 0, kGeluTanh = 1, kQuickGelu = 2, kRelu = 3, kSilu = 4 };
constexpr int kNone = -1;  // fc2: no activation

// act(x) of a bf16 value x, before its final rounding to bf16.  The
// activation is a template argument: a switch on a run-time value inside
// the tile's unrolled epilogue made it some 2x slower as a whole.
template <int kAct>
__device__ __forceinline__ float activate(float x) {
  if constexpr (kAct == kGelu) {
    return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
  } else if constexpr (kAct == kGeluTanh) {  // F.gelu(approximate="tanh")
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  } else if constexpr (kAct == kQuickGelu) {  // x * sigmoid(1.702 x), each op rounded to bf16
    const float z = bf16_round(1.702f * x);
    return x * bf16_round(1.f / (1.f + expf(-z)));
  } else if constexpr (kAct == kRelu) {
    return fmaxf(x, 0.f);
  } else {
    return x / (1.f + expf(-x));  // F.silu
  }
}

// An output value from its f32 sum over the whole depth and its bias:
// fc1's activation kAct of the rounded sum plus b1, or (kNone) fc2's sum
// plus b2.
template <int kAct>
__device__ __forceinline__ float finish(float sum, float bias) {
  if constexpr (kAct == kNone) {
    return sum + bias;
  } else {
    return activate<kAct>(bf16_round(bf16_round(sum) + bias));
  }
}

// The outputs of a run of eight columns from their f32 sums (in split
// order): finish<kAct> with the bias, rounded to bf16, one 16-byte store.
template <int kAct>
struct Finish {
  const bf16* bias;
  bf16* out;
  int cols;

  __device__ __forceinline__ void operator()(int row, int col, const float (&v)[8]) const {
    const uint4 raw = *reinterpret_cast<const uint4*>(bias + col);
    const uint32_t bw[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[j]));
      const __nv_bfloat162 o =
          __floats2bfloat162_rn(finish<kAct>(v[2 * j], b.x), finish<kAct>(v[2 * j + 1], b.y));
      packed[j] = *reinterpret_cast<const uint32_t*>(&o);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * cols + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

// A split's f32 sums of its share of the depth into part, (splits, n,
// cols); rows >= n and columns >= cols are not written.
struct Partial {
  float* part;
  int n, cols;

  __device__ __forceinline__ void operator()(const float (&acc)[128], int m_row, int c0,
                                             int t) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_row + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c0 + 8 * i + 2 * t;  // cols % 8 == 0: col + 1 < cols too
        if (col >= cols) continue;
        *reinterpret_cast<float2*>(part + (static_cast<size_t>(blockIdx.z) * n + row) * cols +
                                   col) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
};

// One product: unsplit, the tile staged in shared memory and finished in
// runs of eight columns; split (gridDim.z > 1), split z's sums into part.
template <int kAct>
__global__ void __launch_bounds__(gemm_wgmma::kThreads, 1)
mlp_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
           const Finish<kAct> fin, float* part, int n, int depth) {
  extern __shared__ unsigned char smem_raw[];
  if (gridDim.z > 1) {
    gemm_wgmma::tile(&amap, &bmap, depth, smem_raw, Partial{part, n, fin.cols});
    return;
  }
  unsigned char* ring = head_wgmma::align_1024(smem_raw);
  if (!gemm_wgmma::tile(&amap, &bmap, depth, smem_raw, gemm_wgmma::Stage{ring})) return;
  gemm_wgmma::staged_runs(ring, n, fin.cols, fin);
}

// One product, (n, depth) a @ (depth, cols) b, then finish<kAct> into out,
// on `splits` depth splits (split: through part and split_sum).
template <int kAct>
cudaError_t product(const void* a, const void* b, const bf16* bias, bf16* out, float* part,
                    int n, int depth, int cols, int splits, cudaStream_t s) {
  CUtensorMap amap, bmap;
  cudaError_t err = gemm_wgmma::box_map(&amap, a, depth, n);
  if (err == cudaSuccess) err = gemm_wgmma::box_map(&bmap, b, cols, depth);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mlp_kernel<kAct>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(gemm_wgmma::kSmemBytes));
  }
  if (err != cudaSuccess) return err;
  const Finish<kAct> fin{bias, out, cols};
  const dim3 grid((cols + gemm_wgmma::kCols - 1) / gemm_wgmma::kCols,
                  (n + gemm_wgmma::kRows - 1) / gemm_wgmma::kRows, splits);
  mlp_kernel<kAct><<<grid, gemm_wgmma::kThreads, gemm_wgmma::kSmemBytes, s>>>(amap, bmap, fin,
                                                                              part, n, depth);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return gemm_wgmma::split_sum(part, fin, splits, n, cols, s);
}

// fc1 with activation kAct, then fc2.
template <int kAct>
cudaError_t mlp(void* x, void* w1, void* b1, void* w2, void* b2, void* h, void* part, void* out,
                int n, int d, int f, int splits1, int splits2, cudaStream_t s) {
  float* scratch = static_cast<float*>(part);
  const cudaError_t err = product<kAct>(x, w1, static_cast<const bf16*>(b1),
                                        static_cast<bf16*>(h), scratch, n, d, f, splits1, s);
  if (err != cudaSuccess) return err;
  return product<kNone>(h, w2, static_cast<const bf16*>(b2), static_cast<bf16*>(out), scratch, n,
                        f, d, splits2, s);
}

}  // namespace

// x (N, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,), h (N, F) scratch,
// out (N, D), all bf16; part f32 scratch of max(splits1 N F, splits2 N D)
// values where either split count exceeds 1 (else unread).  act: an Act;
// splits1 / splits2 cut fc1's D / fc2's F into that many splits of whole
// 64-deep slices (ops/fused_mlp.py::mlp_splits).
extern "C" int mic_fused_mlp_bf16(void* x, void* w1, void* b1, void* w2, void* b2, void* h,
                                  void* part, void* out, int n, int d, int f, int act,
                                  int splits1, int splits2, void* stream) {
  constexpr int kBox = gemm_wgmma::kBox;
  if (n < 1 || d < kBox || d % kBox || f < kBox || f % kBox || act < kGelu || act > kSilu ||
      splits1 < 1 || splits1 > d / kBox || splits2 < 1 || splits2 > f / kBox ||
      (n + gemm_wgmma::kRows - 1) / gemm_wgmma::kRows > 65535 || splits1 > 65535 ||
      splits2 > 65535 || (part == nullptr && (splits1 > 1 || splits2 > 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one instantiation per activation, in the order of enum Act
  constexpr decltype(&mlp<kGelu>) kMlp[] = {mlp<kGelu>, mlp<kGeluTanh>, mlp<kQuickGelu>,
                                           mlp<kRelu>, mlp<kSilu>};
  const cudaError_t err = kMlp[act](x, w1, b1, w2, b2, h, part, out, n, d, f, splits1, splits2,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
