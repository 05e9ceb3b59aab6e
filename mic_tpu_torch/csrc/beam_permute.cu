// Physical beam reorder of a stacked decode KV cache.
//
// Replaces mic_tpu/ops/beam_permute.py::beam_permute (_kernel, one async
// HBM -> HBM DMA per (image, beam) row over every layer).  For kv
// (L, B*K, T, H, Dh) and within-group sources idx (B, K):
//
//   out[l, b*K + n] = kv[l, b*K + idx[b, n]]      for every layer l
//
// a new tensor; kv is only read.  The kernel copies bytes: any element type.
//
// Bound: bytes, the whole array read once and written once (1.61 GB each
// way at the flagship B*K=1024, L=12, T=64, H=16, Dh=64 in bf16: 0.96 ms at
// 3.35 TB/s).  Design: one block per (destination row, layer) streams the
// row's T*H*Dh contiguous elements with 16-byte loads and stores, eight in
// flight per thread, where both row starts are 16-byte aligned, and a tail
// (or the whole row otherwise) element by element.  Offsets are 64-bit: one
// flagship array at B=256 is already near 2**31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_permute_kernel(const T* __restrict__ kv, const int32_t* __restrict__ idx, T* __restrict__ out,
                    int rows, int beams, int64_t row_elems) {
  const int dst = blockIdx.x;
  const int64_t layer = blockIdx.y;
  const int src = dst - dst % beams + idx[dst];
  const T* from = kv + (layer * rows + src) * row_elems;
  T* to = out + (layer * rows + dst) * row_elems;
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(from) | reinterpret_cast<uintptr_t>(to)) & 15) == 0) {
    const int64_t chunks = row_elems * static_cast<int64_t>(sizeof(T)) / 16;
    const uint4* f = reinterpret_cast<const uint4*>(from);
    uint4* t = reinterpret_cast<uint4*>(to);
    constexpr int64_t kStep = static_cast<int64_t>(kThreads) * kUnroll;
    int64_t c = threadIdx.x;
    for (; c + (kUnroll - 1) * kThreads < chunks; c += kStep) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(f + c + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) __stcs(t + c + u * kThreads, v[u]);
    }
    for (; c < chunks; c += kThreads) __stcs(t + c, __ldcs(f + c));
    done = chunks * 16 / static_cast<int64_t>(sizeof(T));
  }
  for (int64_t e = done + threadIdx.x; e < row_elems; e += kThreads) to[e] = from[e];
}

template <typename T>
int launch(const void* kv, const int32_t* idx, void* out, int layers, int rows, int beams,
           int64_t row_elems, cudaStream_t stream) {
  beam_permute_kernel<T><<<dim3(rows, layers), kThreads, 0, stream>>>(
      static_cast<const T*>(kv), idx, static_cast<T*>(out), rows, beams, row_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv and out (layers, rows, row_elems) of elem_bytes-byte elements, rows =
// images x beams; idx (rows,) int32 in [0, beams).  Returns a cudaError_t.
extern "C" int mic_beam_permute(void* kv, void* idx, void* out, int layers, int rows, int beams,
                                long long row_elems, int elem_bytes, void* stream) {
  if (layers < 1 || layers > 65535 || rows < 1 || beams < 1 || rows % beams || row_elems < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i = static_cast<const int32_t*>(idx);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(kv, i, out, layers, rows, beams, row_elems, s);
    case 2: return launch<uint16_t>(kv, i, out, layers, rows, beams, row_elems, s);
    case 4: return launch<uint32_t>(kv, i, out, layers, rows, beams, row_elems, s);
    case 8: return launch<uint64_t>(kv, i, out, layers, rows, beams, row_elems, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
