// PQ decode-and-score scan for Hopper (sm_90a), plain C interface: one
// kernel for the tile-table PQ scan and the full PQ scan.
//
// Replaces two Pallas kernels that compute the same thing and differ in
// which arena tile a step reads and in the residual term:
//   TABLE cloudvectordb_tpu/ops/pallas_pq.py:315 pq_tiles_topk_pallas
//         (body _pq_tiles_kernel :94): step j of query tile qt reads
//         tile_table[qt, j] and merges into pool j % n_pools; optional
//         residual centroid term and top-2 slots;
//   ALL   cloudvectordb_tpu/ops/pallas_pq.py:510 pq_topk_pallas
//         (body _pq_scan_kernel :33): step j reads tile j, no residual
//         term, one pool.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/pq.py::_pq_slots_reference.
//
// What it computes (the reference in interpret mode). Arena row g decodes to
// x[e] = cb[j][code(g, j)][e - j*dsub], j = e / dsub, plus in residual mode
// ct[tile, local[g], e]: one bf16 codeword value plus at most one bf16
// centroid value, added in f32. The score is the f32 dot of the bf16 query
// with that f32 x (f32 FMAs). Mosaic on the TPU may have truncated x to
// bf16; this follows interpret mode. Rows g >= n_valid score -inf and are
// never read. Codes are read through two strides, so the row-major (N, m)
// arena and a code-major (m, N) matrix (K6) need no copy. Each query keeps
// L = l_buckets slots per pool, two with top-2, merged as
// csrc/slot_merge.cuh says; output slot s = pool (or 2 pool, 2 pool + 1
// with top-2) lies at out[s, query, b]. The final top-k over the slots is
// the caller's.
//
// How it maps to the card. The TPU walks the table entries as a sequential
// grid axis, decodes a whole tile into VMEM by one-hot matmuls and carries
// the slots in VMEM. Here one block owns QB queries of one query tile, SB
// consecutive slots and one pool, keeps their running slots in registers
// and loops over its pool's table entries itself (pools are independent),
// so no ordering between blocks is needed. Per step and per r the block
// decodes its SB rows in chunks of KC dimensions straight into shared
// memory as f32 (a direct indexed load of each codeword value and of
// ct[tile, local[g]], no one-hot product), stages the QB queries beside
// them at an odd stride, and runs f32 FMAs as tiles_scan.cu does. The bf16
// codebooks (m * 256 * dsub * 2 bytes, 393 KB at m 64, dsub 12) do not fit
// in shared memory; they are read through L1/L2, where they stay resident.
//
// What bounds it. The least work of the function is the LUT-ADC form: m
// adds per (query, row) scored plus the queries' lookup tables (B * m *
// 2^nbits * dsub multiply-adds), and the bytes are the codes, local bytes
// and centroid tiles of each (query tile, table entry), so its bound is
// small. This simple kernel instead decodes and does 2 * D flops per
// (query, row), on the CUDA cores: it is bound by FMA issue and shared-
// memory loads, far above that bound. LUT-ADC in shared memory, the tensor
// cores and TMA are the next steps for speed; they do not change the
// contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "slot_merge.cuh"

namespace {

constexpr int QB = 32;            // queries per block
constexpr int SB = 64;            // slots per block
constexpr int TX = 16;            // threads along slots
constexpr int TY = 16;            // threads along queries
constexpr int THREADS = TX * TY;  // 256
constexpr int QPT = QB / TY;      // queries per thread
constexpr int SPT = SB / TX;      // slots per thread
constexpr int KC = 64;            // dimensions per staged chunk
constexpr int STRIDE = KC + 1;    // odd stride: conflict-free columns

enum Source { ALL = 0, TABLE = 1 };

struct ScanArgs {
  const uint8_t* codes;     // code of (row g, sub-space j) at g*row_stride + j*sub_stride
  long long row_stride;
  long long sub_stride;
  const uint8_t* local;     // (N,) local list byte, residual mode
  const __nv_bfloat16* cb;  // (m, ncode, dsub)
  const __nv_bfloat16* ct;  // (n_tiles, W, D), residual mode
  const __nv_bfloat16* q;   // (n_qt * tile_q, D)
  const int32_t* table;     // (n_qt, steps), TABLE
  float* out_v;             // (n_slots, n_qt * tile_q, L)
  int32_t* out_i;
  int nq, tile_q, steps, tile_n, l_buckets, m, ncode, dsub, w, n_valid, n_pools;
};

template <int SRC, bool RESID, bool TOP2>
__global__ void __launch_bounds__(THREADS) pq_scan_kernel(const ScanArgs a) {
  __shared__ __align__(16) float smem[(QB + SB) * STRIDE];
  float* q_s = smem;                // QB x STRIDE
  float* r_s = smem + QB * STRIDE;  // SB x STRIDE
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int qblocks = (a.tile_q + QB - 1) / QB;
  const int qt = blockIdx.y / qblocks;
  const int q_lo = qt * a.tile_q + (blockIdx.y % qblocks) * QB;
  const int nq_blk = min(QB, (qt + 1) * a.tile_q - q_lo);
  const int b0 = blockIdx.x * SB;
  const int pid = blockIdx.z;
  const int L = a.l_buckets;
  const int r_per = a.tile_n / L;
  const int d = a.m * a.dsub;

  float v1[QPT][SPT], v2[QPT][SPT];
  int i1[QPT][SPT], i2[QPT][SPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      slot_init(v1[i][jj], i1[i][jj]);
      slot_init(v2[i][jj], i2[i][jj]);
    }

  for (int j = pid; j < a.steps; j += a.n_pools) {
    const int t = SRC == ALL ? j : a.table[(size_t)qt * a.steps + j];
    const long long base = (long long)t * a.tile_n;
    float m1[QPT][SPT], m2[QPT][SPT];
    int r1[QPT][SPT], r2[QPT][SPT];
    for (int r = 0; r < r_per; ++r) {
      const long long row0 = base + (long long)r * L + b0;
      // rows of this block that exist and are live: slots below L, rows in
      // [0, n_valid); the rest are neither read nor ranked
      const long long live_hi = min((long long)min(SB, L - b0), (long long)a.n_valid - row0);
      const int n_rows_blk = row0 < 0 ? 0 : (int)max(0LL, live_hi);
      float acc[QPT][SPT] = {};
      for (int e0 = 0; e0 < d; e0 += KC) {
        const int kn = min(KC, d - e0);
        __syncthreads();  // the previous chunk is done with the staged values
        for (int i = tid; i < QB * KC; i += THREADS) {
          const int qi = i / KC, k = i % KC;
          q_s[qi * STRIDE + k] = (qi < nq_blk && k < kn)
              ? __bfloat162float(a.q[(size_t)(q_lo + qi) * d + e0 + k]) : 0.f;
        }
        for (int i = tid; i < SB * KC; i += THREADS) {
          const int ri = i / KC, k = i % KC;
          float x = 0.f;
          if (ri < n_rows_blk && k < kn) {
            const int e = e0 + k;
            const int sub = e / a.dsub;
            const long long g = row0 + ri;
            const int c = a.codes[g * a.row_stride + (long long)sub * a.sub_stride];
            x = __bfloat162float(a.cb[((size_t)sub * a.ncode + c) * a.dsub + (e - sub * a.dsub)]);
            if (RESID)
              x = __fadd_rn(x, __bfloat162float(a.ct[((size_t)t * a.w + a.local[g]) * d + e]));
          }
          r_s[ri * STRIDE + k] = x;
        }
        __syncthreads();
        for (int k = 0; k < kn; ++k) {
          float qa[QPT], xb[SPT];
#pragma unroll
          for (int i = 0; i < QPT; ++i) qa[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
          for (int jj = 0; jj < SPT; ++jj) xb[jj] = r_s[(tx + TX * jj) * STRIDE + k];
#pragma unroll
          for (int i = 0; i < QPT; ++i)
#pragma unroll
            for (int jj = 0; jj < SPT; ++jj) acc[i][jj] = fmaf(qa[i], xb[jj], acc[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int jj = 0; jj < SPT; ++jj) {
          const float sc = (tx + TX * jj) < n_rows_blk ? acc[i][jj] : -INFINITY;
          if (TOP2)
            tile_take2(sc, r, m1[i][jj], r1[i][jj], m2[i][jj], r2[i][jj]);
          else
            tile_take(sc, r, m1[i][jj], r1[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const long long col = b0 + tx + TX * jj;
        const long long row = base + (long long)r1[i][jj] * L + col;
        if (TOP2)
          slot_merge2(m1[i][jj], row, m2[i][jj], base + (long long)r2[i][jj] * L + col,
                      v1[i][jj], i1[i][jj], v2[i][jj], i2[i][jj]);
        else
          slot_merge(m1[i][jj], row, v1[i][jj], i1[i][jj]);
      }
  }

  const int s1 = TOP2 ? 2 * pid : pid;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int qi = ty + TY * i, b = b0 + tx + TX * jj;
      if (qi < nq_blk && b < L) {
        const size_t o = ((size_t)s1 * a.nq + q_lo + qi) * L + b;
        a.out_v[o] = v1[i][jj];
        a.out_i[o] = i1[i][jj];
        if (TOP2) {
          const size_t o2 = o + (size_t)a.nq * L;
          a.out_v[o2] = v2[i][jj];
          a.out_i[o2] = i2[i][jj];
        }
      }
    }
}

template <int SRC, bool RESID, bool TOP2>
cudaError_t launch(const ScanArgs& a, int n_qt, cudaStream_t stream) {
  const int qblocks = (a.tile_q + QB - 1) / QB;
  const dim3 grid((a.l_buckets + SB - 1) / SB, n_qt * qblocks, a.n_pools);
  pq_scan_kernel<SRC, RESID, TOP2><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the scan on `stream`; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a source/option pair it does not take: ALL is
// the non-residual one-pool scan). `ct` null means no residual term.
int cvdb_pq_scan(int source, int top2, const void* codes, long long row_stride,
                 long long sub_stride, const void* local, const void* cb, const void* ct,
                 const void* q, const void* table, void* out_v, void* out_i, int n_qt,
                 int tile_q, int steps, int tile_n, int l_buckets, int m, int ncode, int dsub,
                 int w, int n_valid, int n_pools, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanArgs a{static_cast<const uint8_t*>(codes), row_stride, sub_stride,
                   static_cast<const uint8_t*>(local), static_cast<const __nv_bfloat16*>(cb),
                   static_cast<const __nv_bfloat16*>(ct), static_cast<const __nv_bfloat16*>(q),
                   static_cast<const int32_t*>(table), static_cast<float*>(out_v),
                   static_cast<int32_t*>(out_i), n_qt * tile_q, tile_q, steps, tile_n,
                   l_buckets, m, ncode, dsub, w, n_valid, n_pools};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resid = ct != nullptr;
  if (source == ALL && !resid && !top2 && n_pools == 1)
    err = launch<ALL, false, false>(a, n_qt, s);
  else if (source != TABLE)
    err = cudaErrorInvalidValue;
  else if (resid)
    err = top2 ? launch<TABLE, true, true>(a, n_qt, s) : launch<TABLE, true, false>(a, n_qt, s);
  else
    err = top2 ? launch<TABLE, false, true>(a, n_qt, s) : launch<TABLE, false, false>(a, n_qt, s);
  return static_cast<int>(err);
}

}  // extern "C"
