// Whole-row tile scan for Hopper (sm_90a), plain C interface: one kernel for
// the flat scan, the tile-table scan and the band scan.
//
// Replaces three Pallas kernels that compute the same thing and differ only
// in which arena tile a step reads:
//   ALL   cloudvectordb_tpu/ops/pallas_topk.py:117 flat_topk_pallas
//         (body _bucketed_topk_kernel :34): step j reads tile j;
//   TABLE cloudvectordb_tpu/ops/pallas_band.py:257 tiles_topk_pallas
//         (body _tiles_kernel :188): step j reads tile_table[qt, j];
//   BAND  cloudvectordb_tpu/ops/pallas_band.py:355 band_topk_pallas
//         (body _band_kernel :135): step j reads band_start[qt] + j.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/band.py::_scan_reference.
//
// What it computes. Arena row g of the step's tile scores s = q . row[g]
// under the score mode, a pair of element types (queries, rows):
//   (int8, int8)   dp4a into exact int32, then one rounding to f32;
//   (bf16, int8)   "hybrid": rows widened to bf16; products exact in f32,
//                  summed in f32;
//   (bf16, bf16)   products exact in f32, summed in f32;
//   (f32, f32)     f32 FMA (no TF32, no tensor cores);
//   (f32, bf16)    f32 queries against a bf16 store, rows widened to f32.
// With sqnorm (the flat index's l2) the score is 2 s - sqnorm[g]. Rows with
// g >= n_valid score -inf and are never read, so a ragged database needs no
// padded copy. Each query keeps L = l_buckets slots, merged as
// csrc/slot_merge.cuh says. The final top-k over the slots is the caller's.
//
// How it maps to the card. The TPU walks the steps as a sequential grid
// axis and carries the slots in VMEM. Here one block owns QB queries of one
// query tile and SB consecutive slots, keeps their running (max, row) in
// registers, and loops over the steps itself, so no ordering between blocks
// is needed. The flat scan is one query tile holding every query. Per step
// and per r the block stages the SB rows, and the QB queries, in chunks of
// the row width (64 values, or 256 int8 values as 64 words), in shared
// memory at an odd stride: the 16 rows a warp reads at one depth sit in 16
// banks. The band start is read from band_start directly; no table is built.
//
// What bounds it. At the whole-row serving shape (hybrid, D = 768, tile_n
// 2048, p in the hundreds, B 4096) the scan is B*p*tile_n*D multiply-adds,
// 0.6e12 at p = 96: at least 18 ms at the card's 33.5 T f32 FMA/s, while
// the rows it stages (<= 19 GB if no tile were reused across blocks) take
// about 6 ms at 3.35 TB/s. The flat scans are the same kind: 1.3e12 FMAs
// for 10,000 queries over 1M x 128 f32 rows, 3.1e12 int8 multiply-adds
// (dp4a) for 4,096 queries over 1M x 768. So this simple kernel is
// compute-bound on the CUDA cores and on the shared-memory loads feeding
// them (6 loads per 8 multiply-adds a thread). The tensor cores (wgmma with
// TMA-staged rows) are the next step for speed; they do not change the
// contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "slot_merge.cuh"

namespace {

constexpr int QB = 32;            // queries per block
constexpr int SB = 64;            // slots per block
constexpr int TX = 16;            // threads along slots
constexpr int TY = 16;            // threads along queries
constexpr int THREADS = TX * TY;  // 256
constexpr int QPT = QB / TY;      // queries per thread
constexpr int SPT = SB / TX;      // slots per thread
constexpr int KC = 64;            // 32-bit words per staged row chunk
constexpr int STRIDE = KC + 1;    // odd word stride: conflict-free columns

enum Source { ALL = 0, TABLE = 1, BAND = 2 };
enum ElemType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// Four int8 values p[e..e+3] as one little-endian word, zero at and past
// e_end; one aligned word load when the row width is a multiple of 4.
__device__ __forceinline__ int32_t load_i8x4(const int8_t* p, int e, int e_end,
                                             bool aligned) {
  if (aligned && e + 4 <= e_end) return *reinterpret_cast<const int32_t*>(p + e);
  uint32_t w = 0;
  for (int b = 0; b < 4; ++b)
    if (e + b < e_end) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[e + b])) << (8 * b);
  return static_cast<int32_t>(w);
}

template <int SRC>
__device__ __forceinline__ int step_tile(const int32_t* table, int qt, int steps, int j) {
  if (SRC == ALL) return j;
  if (SRC == TABLE) return table[(size_t)qt * steps + j];
  return table[qt] + j;  // BAND: band_start[qt] + j
}

// Dot products of the block's queries with the SB rows row0 .. row0+SB-1,
// accumulated into acc over the whole row width in chunks.
template <typename QT, typename RT>
__device__ __forceinline__ void score_rows(const QT* __restrict__ q, const RT* __restrict__ db,
                                           uint32_t* smem, int q_lo, int nq_blk,
                                           long long row0, int n_rows_blk, int d,
                                           float (&out)[QPT][SPT]) {
  constexpr bool kInt8 = std::is_same<QT, int8_t>::value && std::is_same<RT, int8_t>::value;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  if constexpr (kInt8) {
    int32_t* q_s = reinterpret_cast<int32_t*>(smem);  // QB x STRIDE words
    int32_t* r_s = q_s + QB * STRIDE;                 // SB x STRIDE words
    const bool aligned = (d % 4) == 0;
    int acc[QPT][SPT] = {};
    for (int e0 = 0; e0 < d; e0 += 4 * KC) {
      const int kn = min(KC, (d - e0 + 3) / 4);
      __syncthreads();  // the previous chunk is done with the staged words
      for (int i = tid; i < QB * KC; i += THREADS) {
        const int qi = i / KC, k = i % KC;
        q_s[qi * STRIDE + k] = (qi < nq_blk && k < kn)
            ? load_i8x4(q + (size_t)(q_lo + qi) * d, e0 + 4 * k, d, aligned) : 0;
      }
      for (int i = tid; i < SB * KC; i += THREADS) {
        const int ri = i / KC, k = i % KC;
        r_s[ri * STRIDE + k] = (ri < n_rows_blk && k < kn)
            ? load_i8x4(db + (size_t)(row0 + ri) * d, e0 + 4 * k, d, aligned) : 0;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        int a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = r_s[(tx + TX * j) * STRIDE + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) out[i][j] = __int2float_rn(acc[i][j]);
  } else {
    float* q_s = reinterpret_cast<float*>(smem);  // QB x STRIDE
    float* r_s = q_s + QB * STRIDE;               // SB x STRIDE
    float acc[QPT][SPT] = {};
    for (int e0 = 0; e0 < d; e0 += KC) {
      const int kn = min(KC, d - e0);
      __syncthreads();
      for (int i = tid; i < QB * KC; i += THREADS) {
        const int qi = i / KC, k = i % KC;
        q_s[qi * STRIDE + k] = (qi < nq_blk && k < kn)
            ? to_f32(q[(size_t)(q_lo + qi) * d + e0 + k]) : 0.f;
      }
      for (int i = tid; i < SB * KC; i += THREADS) {
        const int ri = i / KC, k = i % KC;
        r_s[ri * STRIDE + k] = (ri < n_rows_blk && k < kn)
            ? to_f32(db[(size_t)(row0 + ri) * d + e0 + k]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        float a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = r_s[(tx + TX * j) * STRIDE + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) out[i][j] = acc[i][j];
  }
}

template <int SRC, typename QT, typename RT>
__global__ void __launch_bounds__(THREADS)
tiles_scan_kernel(const RT* __restrict__ db,         // (N, D) rows
                  const QT* __restrict__ q,          // (Q, D) queries
                  const int32_t* __restrict__ table,  // TABLE (n_qt, steps), BAND (n_qt,)
                  const float* __restrict__ sqnorm,   // (N,) or null: l2 bias
                  float* __restrict__ out_v,          // (Q, L)
                  int32_t* __restrict__ out_i,        // (Q, L)
                  int tile_q, int steps, int tile_n, int l_buckets, int d,
                  int n_valid) {
  __shared__ __align__(16) uint32_t smem[(QB + SB) * STRIDE];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int qblocks = (tile_q + QB - 1) / QB;
  const int qt = blockIdx.y / qblocks;
  const int q_lo = qt * tile_q + (blockIdx.y % qblocks) * QB;
  const int nq_blk = min(QB, (qt + 1) * tile_q - q_lo);
  const int b0 = blockIdx.x * SB;
  const int r_per = tile_n / l_buckets;

  float best_v[QPT][SPT];
  int best_i[QPT][SPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < SPT; ++j) slot_init(best_v[i][j], best_i[i][j]);

  for (int j = 0; j < steps; ++j) {
    const long long base = (long long)step_tile<SRC>(table, qt, steps, j) * tile_n;
    float tmx[QPT][SPT];
    int tr[QPT][SPT];
    for (int r = 0; r < r_per; ++r) {
      const long long row0 = base + (long long)r * l_buckets + b0;
      // rows of this block that exist and are live: slots below L, rows in
      // [0, n_valid); the rest are neither read nor ranked
      const long long live_hi = min((long long)min(SB, l_buckets - b0), (long long)n_valid - row0);
      const int n_rows_blk = row0 < 0 ? 0 : (int)max(0LL, live_hi);
      float s[QPT][SPT];
      score_rows<QT, RT>(q, db, smem, q_lo, nq_blk, row0, n_rows_blk, d, s);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int jj = 0; jj < SPT; ++jj) {
          const int sj = tx + TX * jj;
          float sc = -INFINITY;
          if (sj < n_rows_blk) {
            sc = s[i][jj];
            if (sqnorm != nullptr) sc = __fsub_rn(2.f * sc, sqnorm[row0 + sj]);
          }
          tile_take(sc, r, tmx[i][jj], tr[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj)
        slot_merge(tmx[i][jj], base + (long long)tr[i][jj] * l_buckets + b0 + tx + TX * jj,
                   best_v[i][jj], best_i[i][jj]);
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int qi = ty + TY * i, b = b0 + tx + TX * jj;
      if (qi < nq_blk && b < l_buckets) {
        out_v[(size_t)(q_lo + qi) * l_buckets + b] = best_v[i][jj];
        out_i[(size_t)(q_lo + qi) * l_buckets + b] = best_i[i][jj];
      }
    }
}

template <int SRC, typename QT, typename RT>
cudaError_t launch(const void* db, const void* q, const void* table, const void* sqnorm,
                   void* out_v, void* out_i, int n_qt, int tile_q, int steps, int tile_n,
                   int l_buckets, int d, int n_valid, cudaStream_t stream) {
  const int qblocks = (tile_q + QB - 1) / QB;
  const dim3 grid((l_buckets + SB - 1) / SB, n_qt * qblocks);
  tiles_scan_kernel<SRC, QT, RT><<<grid, THREADS, 0, stream>>>(
      static_cast<const RT*>(db), static_cast<const QT*>(q),
      static_cast<const int32_t*>(table), static_cast<const float*>(sqnorm),
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), tile_q, steps, tile_n,
      l_buckets, d, n_valid);
  return cudaGetLastError();
}

template <int SRC>
cudaError_t launch_types(int qtype, int rtype, const void* db, const void* q,
                         const void* table, const void* sqnorm, void* out_v, void* out_i,
                         int n_qt, int tile_q, int steps, int tile_n, int l_buckets, int d,
                         int n_valid, cudaStream_t stream) {
#define CVDB_SCAN(QT, RT) \
  launch<SRC, QT, RT>(db, q, table, sqnorm, out_v, out_i, n_qt, tile_q, steps, tile_n, \
                      l_buckets, d, n_valid, stream)
  if (qtype == I8 && rtype == I8) return CVDB_SCAN(int8_t, int8_t);
  if (qtype == BF16 && rtype == I8) return CVDB_SCAN(__nv_bfloat16, int8_t);
  if (qtype == BF16 && rtype == BF16) return CVDB_SCAN(__nv_bfloat16, __nv_bfloat16);
  if (qtype == F32 && rtype == F32) return CVDB_SCAN(float, float);
  if (qtype == F32 && rtype == BF16) return CVDB_SCAN(float, __nv_bfloat16);
#undef CVDB_SCAN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the scan on `stream`; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unknown source or type pair).
int cvdb_tiles_scan(int source, int qtype, int rtype, const void* db, const void* q,
                    const void* table, const void* sqnorm, void* out_v, void* out_i,
                    int n_qt, int tile_q, int steps, int tile_n, int l_buckets, int d,
                    int n_valid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (source) {
    case ALL:
      err = launch_types<ALL>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt, tile_q,
                              steps, tile_n, l_buckets, d, n_valid, s);
      break;
    case TABLE:
      err = launch_types<TABLE>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                                tile_q, steps, tile_n, l_buckets, d, n_valid, s);
      break;
    case BAND:
      err = launch_types<BAND>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                               tile_q, steps, tile_n, l_buckets, d, n_valid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
