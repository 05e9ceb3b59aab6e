// Float32-accurate products on Hopper's tensor cores: the 3xTF32 tile of the
// float32 tied head's kernels (row 4's bucket select, csrc/fused_head_f32.cu,
// and row 5's exact/window select, csrc/fused_head.cu's f32::select_kernel)
// and of the float32 flash-CE walks (rows 7 and 8, csrc/flash_ce_f32.cu).
//
// wgmma has no f32 x f32 form, but it has a TF32 one (m64nNk8.f32.tf32.tf32,
// 495 TFLOP/s dense on an H100 SXM, against 67 TFLOP/s of f32 FMAs).  Each
// operand is split as x = hi + lo, hi = x truncated to TF32 (10 mantissa
// bits) and lo = x - hi (exact in f32), of which the tensor core reads the
// top 10 mantissa bits; three TF32 products
//
//   a . b  ~  a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
//
// leave out a_lo . b_lo (under 2^-20 of |a| |b| a term) and lo's own
// truncation (2^-10 of lo), so a D-deep sum keeps float32 accuracy
// (CUTLASS's "3xTF32").  Truncation costs an AND where rounding (cvt.rna)
// costs two conversions a value, on the consumers' path to their products:
// on an H100 the bucket tile at N = 1024 took 4.74-4.96 ms truncated and
// 5.99-6.17 rounded, with log-prob errors against the plain version of
// 7.6e-6 and 5.7e-6 (tools/torch_f32_variants.py's head_round; PERF.md).  Three products at 495 TFLOP/s
// cost what one product at 165 TFLOP/s would: the bound of these kernels,
// 2.5x the FMA rate.
//
// The tile: A, 64 rows of the tied table (V, D) as stored, comes into shared
// memory by TMA in 128-byte-swizzled boxes of 32 f32 (one k8 step is 32
// bytes, as bf16's k16, so head_wgmma.cuh's K-major descriptors and its
// ldmatrix fragment loader apply unchanged); each consumer thread loads its
// fragments by ldmatrix and splits them in registers.  B, 64 hidden rows
// (the heads) or 128 (the CE walks), is split once before the walk
// (split_rows below: hi and lo as two (N, D) arrays, 8 bytes a value, 4 MB
// each at N = 1024) and its hi and lo boxes
// come by TMA beside A's.  TF32 wgmma reads both operands K-major only; both
// are K-major as stored.  The sums run in a fixed order with no atomics, so
// a second launch is bit-equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "head_wgmma.cuh"

namespace tf32x3 {

using namespace head_wgmma;

constexpr int kDepth = 32;           // f32 values of a slice: one 128-byte swizzled row
constexpr int kBox = 64 * 128;       // bytes of a 64-row slice box

// x = hi + lo: hi truncated to TF32, lo = x - hi as f32 bits (the tensor
// core truncates it).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (64 x 64, f32) (+)= a (64 x 8 tf32, registers) . b (64 x 8 tf32, shared,
// K-major).  Thread (warp w of the warpgroup, lane = 4 g + t) holds a rows
// 16 w + g (a[0], a[2]) and 16 w + g + 8 (a[1], a[3]) at k t (a[0], a[1])
// and t + 4 (a[2], a[3]); d[4 i + 2 h + e] is row 16 w + g + 8 h, column
// 8 i + 2 t + e.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) (+)= a (64 x 8 tf32, registers, as above) . b (128 x 8
// tf32, shared, K-major); d[4 i + 2 h + e] is row 16 w + g + 8 h, column
// 8 i + 2 t + e (i < 16).
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// One k8 product of 64 x (2 kRegs) outputs: m64n64k8 or m64n128k8.
template <int kRegs>
__device__ __forceinline__ void product(float (&d)[kRegs], const uint32_t (&a)[4], uint64_t desc_b,
                                        int accumulate) {
  static_assert(kRegs == 32 || kRegs == 64, "a 64- or 128-wide tile");
  if constexpr (kRegs == 32) {
    wgmma_m64n64k8_tf32_rs(d, a, desc_b, accumulate);
  } else {
    wgmma_m64n128k8_tf32_rs(d, a, desc_b, accumulate);
  }
}

// One 32-deep slice of a 64 x (2 kRegs) tile: d = A . B^T (overwritten)
// with A the 64 table rows of a_box and B the 2 kRegs hidden rows (64 or
// 128) of the b_hi and b_lo boxes, in 3xTF32.  The caller adds d into its running sums with FADDs:
// the tensor core truncates every sum it accumulates (an error that grows
// with the depth and does not average out), so a slice's 12 products are
// all it accumulates.  Its 12 products go as one group (32 registers of A
// fragments, held until the group is done; two groups of two k8 steps
// measured the same); the call returns once they are done, so the slot
// may be released (or reused) right after it.  Called by the four warps of
// a consumer warpgroup.
template <int kRegs>
__device__ __forceinline__ void slice_products(float (&d)[kRegs], const unsigned char* a_box,
                                               const unsigned char* b_hi,
                                               const unsigned char* b_lo, int w, int lane) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t raw[4];
    ldsm_a<false>(raw, a_box, w, j, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) split(__uint_as_float(raw[q]), hi[j][q], lo[j][q]);
  }
#pragma unroll
  for (int y = 0; y < kRegs; ++y) fence_operand(d[y]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t bh = desc_sw128(b_hi + 32 * j);
    const uint64_t bl = desc_sw128(b_lo + 32 * j);
    // the small terms first, then the large one
    product(d, lo[j], bh, j != 0);
    product(d, hi[j], bl, 1);
    product(d, hi[j], bh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int y = 0; y < kRegs; ++y) fence_operand(d[y]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fence_operand(hi[j][q]);
      fence_operand(lo[j][q]);
    }
  }
}

// Host: the tensor map of a row-major (rows, D) f32 array read in 32-deep
// boxes of box_rows rows, 128-byte swizzled; rows past the end and depth
// past D arrive as zeros.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int rows, int d,
                               int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, d, rows, kDepth, box_rows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

namespace {  // each including source its own copy of the kernel

// hi and lo of `count4` float4s of x (the hidden rows, before the walk).
__global__ void split_rows_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                                  float4* __restrict__ lo, int64_t count4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
}

// x (n, d) f32, d a multiple of 4 -> hi at out, lo at out + n * d.
inline cudaError_t split_rows(const void* x, void* out, int n, int d, cudaStream_t stream) {
  const int64_t count4 = static_cast<int64_t>(n) * d / 4;
  const int blocks = static_cast<int>((count4 + 255) / 256 < 1024 ? (count4 + 255) / 256 : 1024);
  float4* hi = static_cast<float4*>(out);
  split_rows_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(x), hi, hi + count4,
                                                count4);
  return cudaGetLastError();
}

}  // namespace

}  // namespace tf32x3
