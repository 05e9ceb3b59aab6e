// The float32 bucket select of the tied head: row 4 for a float32 model.
//
// Replaces mic_tpu/ops/fused_head.py::fused_head_topk's bucket kernels
// (_kernel_bucket_acc / _kernel_bucket) where the hidden rows and the table
// are float32 (CaptionerConfig.dtype "float32": mic_tpu casts the table to
// hidden.dtype and runs the same kernel).  The logits s = hidden @ weight^T
// + bias are computed to float32 accuracy and never stored.  The vocab is
// cut into chunks of `buckets` columns (the bucket_bv width); bucket column
// j of a hidden row keeps, over the chunks in order, as csrc/fused_head.cu's
// bf16 bucket kernel does,
//
//   l[j]    += exp(min(s, 60))                    (fixed-offset sum of exps)
//   rmax[j], rid[j] <- s, id   where s > rmax[j]  (strict: earliest chunk wins)
//
// over the columns id = c * buckets + j < V (rid starts at chunk 0's id, as
// the dense select's).  Each run of chunks writes its own (N, buckets)
// planes; ops/fused_head.py::bucket_finish_runs merges them in run order and
// finishes lse and the top-k of the bucket winners.  Two routes:
//
// The 3xTF32 tile (many rows; route 0).  csrc/tf32x3_wgmma.cuh's tile on the
// bf16 bucket kernel's walk: a block owns 64 hidden rows x 64 bucket columns
// and a run of chunks; the vocab is wgmma's M side (the 64 table rows of a
// chunk's column group, split into TF32 hi and lo in registers), the hidden
// rows its N side (hi and lo split before the walk).  Float32 hidden rows
// cannot stay resident as the bf16 kernel keeps them (64 rows x D = 1024 x
// 8 bytes is 512 KB), so every ring stage holds the hidden rows' hi and lo
// boxes beside the table slices of a pair of chunks (one for each consumer
// warpgroup; 32 KB a stage, seven stages), as the flash-CE walk streams
// both of its operands.  Each slice's products are summed into the chunk's
// logits by FADDs (tf32x3::slice_products).  Each thread owns the same
// (bucket column, hidden row) cells for the whole walk and keeps their
// rmax and rid, and its rows' sums of exps, in registers (the planes' l
// holds a thread's two columns' sum at the first); the two warpgroups'
// cells merge through the ring at the end.
// Bound at the flagship decode shape (N = 1024, D = 1024, V = 250054):
// 3 x 2 N D V = 1.57 TFLOP at 495 TFLOP/s, 3.18 ms (165 TFLOP/s of
// float32-accurate products); the FFMA tile it replaces was bound by the
// f32 FMA rate, 7.83 ms, and took 17.6; this one takes 4.6-4.8 on an H100
// (PERF.md).  The blocks re-read the hidden boxes and their chunks' table
// rows from L2 (about 33 GB at N = 1024).
//
// The stream (up to four rows; route 4).  At a few rows the work is the
// read of the table (1.02 GB, 0.306 ms at 3.35 TB/s); a 64-row tile wastes
// most of its products.  The hidden rows are held in shared memory; a
// warp owns one bucket column and walks its chunks two
// table rows at a time, each lane 16-byte loads of its pieces of the rows
// (8 KB a warp in flight), f32 FMAs against every held row (2 N operations
// a 4-byte value: below the FMA rate's line up to N of about 32), the dots
// summed over the warp by a butterfly, lane r keeping row r's (l, rmax,
// rid) in registers.  Short runs of chunks (grid y) fill the card with
// many small blocks.  The route is ops/fused_head.py::bucket_f32_route's:
// on an H100, timed in turns in one process (tools/torch_time_rows.py
// --cases f32few), the stream took 0.405-0.411 ms at N = 1 against the
// tile's 0.500-0.504 (and the plain version's 0.441), 0.416-0.417 at N = 2
// against 0.424, 0.420-0.421 at N = 4 against 0.424-0.426; held at 8 rows
// it took 0.438-0.456 at N = 5 and 8 against the tile's 0.422-0.435
// (PERF.md), so it holds 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3_wgmma.cuh"

namespace {

using namespace head_wgmma;

constexpr float kNegInf = -1e30f;  // NEG_INF of mic_tpu/ops/topk_lse.py
constexpr float kExpClamp = 60.f;  // _EXP_CLAMP of mic_tpu/ops/fused_head.py
constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// Route 0: the 3xTF32 tile.

constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // and the producer's warpgroup
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRows = 64;                 // hidden rows a block (wgmma's N)
constexpr int kCols = 64;                 // bucket columns a block (wgmma's M)
constexpr int kBox = tf32x3::kBox;        // one 64-row, 32-deep f32 box
constexpr int kStage = 4 * kBox;          // hidden hi, hidden lo, a pair of chunks' slices
constexpr int kStages = 7;
constexpr int kMerge = 3 * 32 * 128 * 4;  // the warpgroups' merge, through the ring
constexpr size_t kTileSmem = 1024 + static_cast<size_t>(kStages) * kStage +
                             2 * kStages * sizeof(uint64_t);
static_assert(kTileSmem <= kMaxSmem && kMerge <= kStages * kStage, "the tile's shared memory");

__global__ void __launch_bounds__(kThreads, 1)
bucket_tf32_kernel(const __grid_constant__ CUtensorMap wmap,   // weight (V, D), 64-row boxes
                   const __grid_constant__ CUtensorMap himap,  // hidden hi (N, D)
                   const __grid_constant__ CUtensorMap lomap,  // hidden lo (N, D)
                   const float* __restrict__ bias,             // (V,)
                   float* __restrict__ l_out,                  // (splits, N, buckets)
                   float* __restrict__ rmax_out,
                   int32_t* __restrict__ rid_out, int n, int d, int vocab, int buckets) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [stage][hi, lo, chunk, chunk + 1][64 rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int nk = (d + tf32x3::kDepth - 1) / tf32x3::kDepth;
  // this block's run of chunks [c_begin, c_end), split z of gridDim.z,
  // walked as pairs: warpgroup w takes chunk c_begin + 2 p + w of pair p
  const int nchunks = (vocab + buckets - 1) / buckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nchunks / gridDim.z);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nchunks / gridDim.z);
  const int npairs = (c_end - c_begin + 1) / 2;
  const int nslices = npairs * nk;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: stage s holds depth slice s % nk of the hidden rows (hi, lo)
    // and of the pair's two chunks; rows past n or V arrive as zeros
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= kStages) mbar_wait(&empty[slot], phase ^ 1);
        const int chunk = c_begin + 2 * (s / nk);
        const int kk = (s % nk) * tf32x3::kDepth;
        const bool second = chunk + 1 < c_end;
        unsigned char* dst = ring + slot * kStage;
        mbar_expect_tx(&full[slot], (second ? 4 : 3) * kBox);
        tma_load_2d(dst, &himap, &full[slot], kk, row0);
        tma_load_2d(dst + kBox, &lomap, &full[slot], kk, row0);
        tma_load_2d(dst + 2 * kBox, &wmap, &full[slot], kk, chunk * buckets + col0);
        if (second) {
          tma_load_2d(dst + 3 * kBox, &wmap, &full[slot], kk, (chunk + 1) * buckets + col0);
        }
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[32], part[32];
  // l by hidden row: l_st[2 i + e] sums the thread's two columns of row
  // 8 i + 2 t + e (the finish sums a row's columns); rmax and rid by cell
  float l_st[16], m_st[32];
  int id_st[32];
  // bucket columns col0 + 16 w + g + 8 h of the block (table rows of a
  // chunk's column group); a column at or past `buckets` is the next
  // chunk's and is left out
  const int bcol = col0 + 16 * w + g;
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    m_st[x] = kNegInf;
    id_st[x] = bcol + 8 * ((x >> 1) & 1);  // chunk 0's id, as the dense select's
  }
#pragma unroll
  for (int x = 0; x < 16; ++x) l_st[x] = 0.f;
  int slot = 0, phase = 0;
  auto advance = [&]() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  };
  for (int p = 0; p < npairs; ++p) {
    const int chunk = c_begin + 2 * p + wg;
    if (chunk >= c_end) {  // warpgroup-uniform: the last pair of an odd run
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[slot], phase);
        release(empty, slot);
        advance();
      }
      continue;
    }
    const int vbase = chunk * buckets + bcol;
    // the chunk's biases, loaded while its products run
    bool valid[2];
    float bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = bcol + 8 * h < buckets && vbase + 8 * h < vocab;
      bv[h] = valid[h] ? __ldg(bias + vbase + 8 * h) : 0.f;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[slot], phase);
      const unsigned char* stage = ring + slot * kStage;
      tf32x3::slice_products(part, stage + (2 + wg) * kBox, stage, stage + kBox, w, lane);
      release(empty, slot);
      advance();
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] = __fadd_rn(acc[x], part[x]);
    }
    // the bucket update: d[4 i + 2 h + e] is table row vbase + 8 h (bucket
    // column bcol + 8 h), hidden row 8 i + 2 t + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = vbase + 8 * h;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e;
          const float sc = valid[h] ? __fadd_rn(acc[x], bv[h]) : kNegInf;
          l_st[2 * i + e] += expf(fminf(sc, kExpClamp));
          if (sc > m_st[x]) {
            m_st[x] = sc;
            id_st[x] = v;
          }
        }
      }
    }
  }

  // the two warpgroups' cells, through the ring (every slot has been read)
  consumer_sync(kConsumerThreads);
  float* xl = reinterpret_cast<float*>(ring);
  float* xm = xl + 32 * 128;
  int* xi = reinterpret_cast<int*>(xm + 32 * 128);
  const int me = tid & 127;
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      if (x < 16) xl[x * 128 + me] = l_st[x];
      xm[x * 128 + me] = m_st[x];
      xi[x * 128 + me] = id_st[x];
    }
  }
  consumer_sync(kConsumerThreads);
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 16; ++x) l_st[x] += xl[x * 128 + me];
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float om = xm[x * 128 + me];
      const int oi = xi[x * 128 + me];
      if (om > m_st[x] || (om == m_st[x] && oi < id_st[x])) {
        m_st[x] = om;
        id_st[x] = oi;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * i + 2 * t + e;
        if (r < n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            if (bcol + 8 * h < buckets) {
              const size_t o = (static_cast<size_t>(blockIdx.z) * n + r) * buckets + bcol + 8 * h;
              l_out[o] = h ? 0.f : l_st[2 * i + e];  // a column past `buckets` adds 0
              rmax_out[o] = m_st[x];
              rid_out[o] = id_st[x];
            }
          }
        }
      }
    }
  }
}

int launch_tile(const void* hidden, const void* weight, const void* bias, void* hsplit,
                void* l_out, void* rmax_out, void* rid_out, int n, int d, int vocab,
                int buckets, int splits, cudaStream_t stream) {
  cudaError_t err = tf32x3::split_rows(hidden, hsplit, n, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lo = static_cast<const float*>(hsplit) + static_cast<size_t>(n) * d;
  CUtensorMap wmap, himap, lomap;
  err = tf32x3::encode_rows(&wmap, weight, vocab, d, kCols);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&himap, hsplit, n, d, kRows);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&lomap, lo, n, d, kRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bucket_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTileSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, (buckets + kCols - 1) / kCols, splits);
  bucket_tf32_kernel<<<grid, kThreads, kTileSmem, stream>>>(
      wmap, himap, lomap, static_cast<const float*>(bias), static_cast<float*>(l_out),
      static_cast<float*>(rmax_out), static_cast<int32_t*>(rid_out), n, d, vocab, buckets);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The stream: a warp a bucket column, the held rows in shared memory.

constexpr int kStreamWarps = 8;
constexpr int kPieces = 8;  // 16-byte pieces a lane holds of a table row: 1024 values a warp
constexpr int kHeld = 4;    // hidden rows the stream holds (N <= 4)

__global__ void __launch_bounds__(kStreamWarps * 32)
bucket_stream_kernel(const float* __restrict__ hidden,  // (N, D), N <= kHeld
                     const float* __restrict__ weight,  // (V, D)
                     const float* __restrict__ bias,    // (V,)
                     float* __restrict__ l_out,         // (splits, N, buckets)
                     float* __restrict__ rmax_out,
                     int32_t* __restrict__ rid_out, int n, int d, int vocab, int buckets) {
  extern __shared__ float4 held[];  // [kHeld][D / 4], rows past n zero
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kHeld * d4; i += blockDim.x) {
    const int r = i / d4;
    held[i] = r < n ? reinterpret_cast<const float4*>(hidden)[static_cast<size_t>(r) * d4 + i % d4]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kStreamWarps + (threadIdx.x >> 5);  // the warp's bucket column
  if (j >= buckets) return;
  const int nchunks = (vocab + buckets - 1) / buckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * nchunks / gridDim.y);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * nchunks / gridDim.y);
  const float4* w4 = reinterpret_cast<const float4*>(weight);
  float l = 0.f, m = kNegInf;
  int id = j;  // chunk 0's id, as the dense select's
  for (int c = c_begin; c < c_end; c += 2) {
    // table rows v[x] = (c + x) * buckets + j of the pair's chunks (warp-uniform)
    int v[2];
    bool ok[2];
    float b[2];  // the rows' biases, requested with their pieces
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      v[x] = (c + x) * buckets + j;
      ok[x] = c + x < c_end && v[x] < vocab;
      b[x] = ok[x] ? __ldg(bias + v[x]) : 0.f;
    }
    float dot[2][kHeld];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int r = 0; r < kHeld; ++r) dot[x][r] = 0.f;
    }
    for (int base = 0; base < d4; base += 32 * kPieces) {
      float4 a[2][kPieces];
#pragma unroll
      for (int q = 0; q < kPieces; ++q) {
        const int p = base + lane + 32 * q;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          a[x][q] = ok[x] && p < d4 ? __ldg(w4 + static_cast<size_t>(v[x]) * d4 + p)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int q = 0; q < kPieces; ++q) {
        const int p = base + lane + 32 * q;
        if (p < d4) {
#pragma unroll
          for (int r = 0; r < kHeld; ++r) {
            const float4 h = held[r * d4 + p];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              float s = dot[x][r];
              s = fmaf(a[x][q].x, h.x, s);
              s = fmaf(a[x][q].y, h.y, s);
              s = fmaf(a[x][q].z, h.z, s);
              s = fmaf(a[x][q].w, h.w, s);
              dot[x][r] = s;
            }
          }
        }
      }
    }
    // each dot summed over the warp (a butterfly: every lane ends with it)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int r = 0; r < kHeld; ++r) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot[x][r] += __shfl_xor_sync(0xffffffffu, dot[x][r], o);
      }
    }
    // lane r < n updates row r's cell, chunk c before chunk c + 1
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (!ok[x]) continue;  // warp-uniform
      float mine = dot[x][0];
#pragma unroll
      for (int r = 1; r < kHeld; ++r) mine = lane == r ? dot[x][r] : mine;
      const float sc = __fadd_rn(mine, b[x]);
      l += expf(fminf(sc, kExpClamp));
      if (sc > m) {
        m = sc;
        id = v[x];
      }
    }
  }
  if (lane < n) {
    const size_t o = (static_cast<size_t>(blockIdx.y) * n + lane) * buckets + j;
    l_out[o] = l;
    rmax_out[o] = m;
    rid_out[o] = id;
  }
}

int launch_stream(const void* hidden, const void* weight, const void* bias, void* l_out,
                  void* rmax_out, void* rid_out, int n, int d, int vocab, int buckets,
                  int splits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kHeld) * d * 4;
  if (n > kHeld || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bucket_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((buckets + kStreamWarps - 1) / kStreamWarps, splits);
  bucket_stream_kernel<<<grid, kStreamWarps * 32, smem, stream>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(l_out), static_cast<float*>(rmax_out),
      static_cast<int32_t*>(rid_out), n, d, vocab, buckets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hidden (N, D), weight (V, D) and bias (V,) float32, D a multiple of 4; the
// planes l, rmax, rid are (splits, N, buckets), each run's own.  route 0:
// the 3xTF32 tile, with hsplit (2, N, D) f32 scratch for the hidden rows'
// hi and lo; route 4: the stream, holding up to 4 rows (hsplit unused).
extern "C" int mic_fused_head_bucket_f32(void* hidden, void* weight, void* bias, void* hsplit,
                                         void* l_out, void* rmax_out, void* rid_out, int n,
                                         int d, int vocab, int buckets, int splits, int route,
                                         void* stream) {
  const int nchunks = (vocab + buckets - 1) / buckets;
  if (n < 1 || d < 4 || d % 4 || vocab < 1 || buckets < 1 || splits < 1 || splits > nchunks ||
      splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return launch_tile(hidden, weight, bias, hsplit, l_out, rmax_out, rid_out, n, d, vocab,
                         buckets, splits, s);
    case kHeld:
      return launch_stream(hidden, weight, bias, l_out, rmax_out, rid_out, n, d, vocab,
                           buckets, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
