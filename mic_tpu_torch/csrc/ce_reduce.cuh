// The flash-CE kernels' second passes, shared by the bf16 walk
// (csrc/flash_ce.cu) and the float32 one (csrc/flash_ce_f32.cu): the merge
// of the forward's per-run row statistics and the sum of per-band (or
// per-part) partials.  Both fold in a fixed order, so reruns are bit-equal.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

// Folds the runs' partials in run order: lse = m + log(sum_z s_z e^(m_z - m)).
__global__ void flash_ce_fwd_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_s,
                                          const float* __restrict__ part_z,
                                          float* __restrict__ lse, float* __restrict__ zsum,
                                          int n, int runs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m = -FLT_MAX;  // finfo(float32).min, NEG of mic_tpu/ops/flash_ce.py
  for (int z = 0; z < runs; ++z) m = fmaxf(m, part_m[static_cast<size_t>(z) * n + i]);
  float s = 0.f, t = 0.f;
  for (int z = 0; z < runs; ++z) {
    const size_t o = static_cast<size_t>(z) * n + i;
    s += part_s[o] * expf(part_m[o] - m);
    t += part_z[o];
  }
  lse[i] = m + logf(s);
  zsum[i] = t;
}

// dbias[v] = sum of the row bands' partials, in band order (also grad-h's dh
// from its vocab parts' partials, in part order).
__global__ void flash_ce_band_sum_kernel(const float* __restrict__ band_part,
                                         float* __restrict__ dbias, int bands, int vocab) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vocab) return;
  float acc = 0.f;
  for (int b = 0; b < bands; ++b) acc += band_part[static_cast<size_t>(b) * vocab + v];
  dbias[v] = acc;
}

}  // namespace
