// LayerNorm folded into a dense on a float32 model: out = layer_norm(x) @ W + b.
//
// Replaces mic_tpu/ops/ln_gemm.py::ln_gemm (_ln_gemm_kernel) at float32, the
// decode step's ln_self -> fused q/k/v projection under
// MIC_TPU_EXPERIMENTAL=ln_qkv on the default float32 model.  mic_tpu's
// kernel rounds the normalised row to the weight's dtype and the sum to x's,
// which at float32 round nothing: f32 statistics (the mean, then the mean of
// squared deviations), xn = (x - mean) * rsqrt(var + eps) * scale + shift
// in f32, an f32 product with f32 accumulation (no TF32), the bias added.
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// O = 3072) 6.4 GFLOP against 17 MB; bytes at small N (N = 32: W's 12.6 MB).
// Design: float32-accurate products on the tensor cores, three TF32
// products a term (3xTF32, as csrc/tf32x3_wgmma.cuh: each operand split
// into a TF32 hi and the f32 rest lo; a_lo b_hi + a_hi b_lo + a_hi b_hi),
// on mma.sync.m16n8k8, whose fragments come from shared memory in any
// layout: TF32 wgmma reads both operands K-major only, and W (D, O) is
// MN-major as stored.  An FFMA tile (8 x 8 sums a thread) took 0.2304 ms
// at the flagship step, slower than the plain version (PERF.md §6).
//   - the row statistics first, by their own small kernel (a warp a row,
//     the row read twice, 2 x 4 bytes a row written), so that the GEMM's
//     column tiles do not each recompute them;
//   - a 128 x 96 output tile a block of eight warps, each warp 64 rows x 24
//     columns (four 16-row by three 8-column mma tiles), over 16-deep
//     slices double-buffered in shared memory: the next slice's raw x and
//     W are loaded into registers while the current one's products run,
//     x normalised on its way to shared memory; at the flagship 256 tiles,
//     two waves of the 132 SMs;
//   - each slice's products go into zeroed sums that FADDs add to the
//     running ones (the tensor core truncates what it accumulates,
//     csrc/tf32x3_wgmma.cuh);
//   - where the tiles leave SMs idle (N = 32: 32 tiles) the depth is cut
//     into splits of whole slices (ops/ln_gemm.py::ln_splits_f32), their
//     f32 partials summed in split order with the bias by a second kernel.
// Rows past N are normalised with mean 0 and rstd 0 and never written; W's
// columns past O are read as zeros and never written.  Every sum has one
// fixed order: reruns are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace ln_f32 {

constexpr int kRows = 128;   // output rows of a block
constexpr int kCols = 96;    // output columns of a block
constexpr int kDepth = 16;   // the depth of a slice
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The statistics of rows blockIdx.x * 8 ..: a warp a row, the sum lane by
// lane (float4 runs) and across the warp, the mean, then the squared
// deviations the same way; rstd in round-to-nearest.
__global__ void __launch_bounds__(kThreads) stats_kernel(const float* __restrict__ x,
                                                         float* __restrict__ mean,
                                                         float* __restrict__ rstd, int n, int d,
                                                         float eps) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  float q = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    const float e[4] = {v.x - mu, v.y - mu, v.z - mu, v.w - mu};
#pragma unroll
    for (int j = 0; j < 4; ++j) q = fmaf(e[j], e[j], q);
  }
  const float var = __fdiv_rn(warp_sum(q), static_cast<float>(d));
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = __frsqrt_rn(var + eps);
  }
}

struct Args {
  const float* x;      // (n, d)
  const float* scale;  // (d,)
  const float* shift;  // (d,)
  const float* w;      // (d, o)
  const float* bias;   // (o,)
  const float* mean;   // (n,)
  const float* rstd;   // (n,)
  float* part;         // (splits, n, o) where split, else unread
  float* out;          // (n, o)
  int n, d, o;
};

// x = hi + lo: hi truncated to TF32 (10 mantissa bits), lo = x - hi as f32
// bits (the tensor core reads its top 10 mantissa bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32): thread (g = lane
// / 4, t = lane % 4) holds a rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at
// k t (a[0], a[1]) and t + 4 (a[2], a[3]); b at k t (b[0]) and t + 4
// (b[1]), column g; d rows g (d[0], d[1]) and g + 8 (d[2], d[3]), columns
// 2 t and 2 t + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMTiles = 4;                 // 16-row tiles of a warp's 64 rows
constexpr int kNTiles = kCols / 4 / 8;     // 8-column tiles of a warp's 24 columns
constexpr int kXPitch = kDepth + 4;        // f32 of a staged x row: fragment reads spread
constexpr int kWPitch = kCols + 8;         // f32 of a staged W row: fragment reads spread
constexpr int kWVecs = kDepth * kCols / 4; // float4 of W a slice

__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  __shared__ __align__(16) float xs[2][kRows][kXPitch];  // normalised x, K-major
  __shared__ __align__(16) float ws[2][kDepth][kWPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  const int slices = a.d / kDepth;
  const int s0 = static_cast<int>(static_cast<int64_t>(blockIdx.z) * slices / gridDim.z);
  const int s1 = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * slices / gridDim.z);

  // loads: x row xr's eight columns xc.. of a slice, normalised on the way;
  // W's float4 f = tid and tid + 256 of the slice's kDepth x kCols
  const int xr = tid >> 1;
  const int xc = 8 * (tid & 1);
  const bool x_live = m0 + xr < a.n;
  const float mu = x_live ? a.mean[m0 + xr] : 0.f;
  const float rs = x_live ? a.rstd[m0 + xr] : 0.f;
  const float* xrow = a.x + static_cast<size_t>(x_live ? m0 + xr : 0) * a.d + xc;

  auto load = [&](int s, float (&xn)[8], float4 (&wv)[2]) {
    const int k = s * kDepth;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = x_live ? *reinterpret_cast<const float4*>(xrow + k + 4 * h)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 sc = *reinterpret_cast<const float4*>(a.scale + k + xc + 4 * h);
      const float4 sh = *reinterpret_cast<const float4*>(a.shift + k + xc + 4 * h);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const float ss[4] = {sc.x, sc.y, sc.z, sc.w};
      const float hh[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xn[4 * h + j] = __fadd_rn(__fmul_rn(__fmul_rn(vv[j] - mu, rs), ss[j]), hh[j]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = tid + h * kThreads;
      const int row = f / (kCols / 4);
      const int col = c0 + 4 * (f % (kCols / 4));
      wv[h] = f < kWVecs && col < a.o
                  ? *reinterpret_cast<const float4*>(a.w + static_cast<size_t>(k + row) * a.o +
                                                     col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int buf, const float (&xn)[8], const float4 (&wv)[2]) {
    *reinterpret_cast<float4*>(&xs[buf][xr][xc]) = make_float4(xn[0], xn[1], xn[2], xn[3]);
    *reinterpret_cast<float4*>(&xs[buf][xr][xc + 4]) = make_float4(xn[4], xn[5], xn[6], xn[7]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = tid + h * kThreads;
      if (f < kWVecs) {
        *reinterpret_cast<float4*>(&ws[buf][f / (kCols / 4)][4 * (f % (kCols / 4))]) = wv[h];
      }
    }
  };

  // warp (wm, wn): rows 64 wm.., columns 24 wn..
  const int wm = warp & 1;
  const int wn = warp >> 1;
  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  float xn[8];
  float4 wv[2];
  if (s0 < s1) {
    load(s0, xn, wv);
    store(0, xn, wv);
  }
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    if (s + 1 < s1) load(s + 1, xn, wv);
    // the slice's three TF32 products a term into zeroed sums, then added
    // to the running sums by FADDs (the tensor core truncates what it
    // accumulates)
    float part[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kDepth; k0 += 8) {
      uint32_t bh[kNTiles][2], bl[kNTiles][2];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = 24 * wn + 8 * j + g;
        split(ws[buf][k0 + t][col], bh[j][0], bl[j][0]);
        split(ws[buf][k0 + t + 4][col], bh[j][1], bl[j][1]);
      }
      uint32_t ah[kMTiles][4], al[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const int row = 64 * wm + 16 * i + g;
        split(xs[buf][row][k0 + t], ah[i][0], al[i][0]);
        split(xs[buf][row + 8][k0 + t], ah[i][1], al[i][1]);
        split(xs[buf][row][k0 + t + 4], ah[i][2], al[i][2]);
        split(xs[buf][row + 8][k0 + t + 4], ah[i][3], al[i][3]);
      }
      // each of the three products over the twelve tiles before the next,
      // so that no mma waits on the one before it
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    if (s + 1 < s1) store(buf ^ 1, xn, wv);
    __syncthreads();
  }

  const bool split_z = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + 64 * wm + 16 * i + g + 8 * hf;
      if (row >= a.n) continue;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = c0 + 24 * wn + 8 * j + 2 * t;
        if (col >= a.o) continue;
        float2 v = make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
        const size_t at = static_cast<size_t>(row) * a.o + col;
        if (split_z) {
          *reinterpret_cast<float2*>(a.part + static_cast<size_t>(blockIdx.z) * a.n * a.o + at) =
              v;
        } else {
          const float2 b = *reinterpret_cast<const float2*>(a.bias + col);
          v.x += b.x;
          v.y += b.y;
          *reinterpret_cast<float2*>(a.out + at) = v;
        }
      }
    }
  }
}

// out = the splits' partial sums added in split order, then the bias; four
// columns a thread.
__global__ void __launch_bounds__(kThreads) split_sum_kernel(const float* __restrict__ part,
                                                             const float* __restrict__ bias,
                                                             float* __restrict__ out, int splits,
                                                             int n, int o) {
  const size_t plane = static_cast<size_t>(n) * o;
  for (size_t run = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; run < plane / 4;
       run += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(part)[run];
    for (int z = 1; z < splits; ++z) {
      const float4 p = reinterpret_cast<const float4*>(part + z * plane)[run];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float4 b = reinterpret_cast<const float4*>(bias)[(4 * run % o) / 4];
    v.x += b.x;
    v.y += b.y;
    v.z += b.z;
    v.w += b.w;
    reinterpret_cast<float4*>(out)[run] = v;
  }
}

}  // namespace ln_f32
}  // namespace

// x (N, D), scale and shift (D,), w (D, O), bias (O,), out (N, O), all f32;
// stats f32 scratch of 2 N values (the rows' mean, then rstd); part f32
// scratch of splits N O values where splits > 1 (else unread).  splits cuts
// the D / 16 slices of the depth into that many splits
// (ops/ln_gemm.py::ln_splits_f32).
extern "C" int mic_ln_gemm_f32(void* x, void* scale, void* shift, void* w, void* bias,
                               void* stats, void* part, void* out, int n, int d, int o, float eps,
                               int splits, void* stream) {
  using namespace ln_f32;
  if (n < 1 || d < kDepth || d % 32 || o < 64 || o % 64 || splits < 1 ||
      splits > d / kDepth || splits > 65535 || (n + kRows - 1) / kRows > 65535 ||
      (part == nullptr && splits > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean = static_cast<float*>(stats);
  float* rstd = mean + n;
  const int warps = kThreads / 32;
  stats_kernel<<<(n + warps - 1) / warps, kThreads, 0, s>>>(static_cast<const float*>(x), mean,
                                                           rstd, n, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(scale),
               static_cast<const float*>(shift), static_cast<const float*>(w),
               static_cast<const float*>(bias), mean, rstd, static_cast<float*>(part),
               static_cast<float*>(out), n, d, o};
  const dim3 grid((o + kCols - 1) / kCols, (n + kRows - 1) / kRows, splits);
  gemm_kernel<<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t runs = static_cast<size_t>(n) * o / 4;
  const int blocks = static_cast<int>(runs < 1024 * 256 ? (runs + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(part),
                                               static_cast<const float*>(bias),
                                               static_cast<float*>(out), splits, n, o);
  return static_cast<int>(cudaGetLastError());
}
