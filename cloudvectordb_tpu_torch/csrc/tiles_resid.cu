// Residual-int8 tile-table scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel cloudvectordb_tpu/ops/pallas_band.py
// ::tiles_topk_resid_pallas (body _tiles_resid_kernel), in its serving
// variant: int8 queries, no row mask, inner product, one slot per bucket.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes; the plain PyTorch version of the same
// contract is ops/band.py::tiles_topk_resid_reference.
//
// What it computes. For query tile qt and table entry p (arena tile
// t = tile_table[qt, p]), every arena row g of tile t scores
//     c_score + row_scale[q] * (q8[q] . r8[g])
// where c_score = bf16(q) . bf16(centroid_tiles[t, local[g]]) with f32
// accumulation, and the int8 dot accumulates exactly in int32. Row g is
// live iff g < valid_end[t, local[g]]. Each query keeps L = l_buckets slots:
// within a tile, slot b takes the best of rows t*tile_n + r*L + b over r
// (smallest r on ties); across table entries a strict '>' keeps the earlier
// entry. Slots start at (-inf, row 0). The final top-k over the slots is
// done by the caller.
//
// How it maps to the card. The TPU walks the table entries as a sequential
// grid axis and carries the slots in VMEM between steps. Here one block owns
// QB queries of one query tile and SB consecutive slots, keeps their running
// (max, row) in registers, and loops over the P table entries itself, so no
// ordering between blocks is needed. Per table entry the block stages the SB
// int8 rows in shared memory (rows padded to an odd word stride, so the 16
// rows a warp reads at one depth sit in 16 distinct banks), computes the
// centroid products for just the lists those rows belong to (an indexed
// load of the centroid row; the TPU needed a two-pass one-hot matmul for
// this), and scores with __dp4a. The validity mask is a direct load of
// valid_end (the TPU needed an 8-bit radix split through the matmul).
//
// What bounds it. At the serving shape (D=768, tile_n=2048, P in the
// hundreds, B=4096) the scan does ~B*P*tile_n*D int8 multiply-adds: about
// 1.2e12 at P=192, or 1.3 ms on the int8 tensor cores but tens of ms through
// dp4a on the CUDA cores, while its row traffic (<= 19 GB if no tile were
// reused across blocks, ~6 ms at 3.35 TB/s) is smaller. So this simple
// kernel is compute-bound on dp4a and on shared-memory reads feeding it.
// Moving the residual product to wgmma s8 with TMA-staged rows is the next
// step for speed; it does not change the contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int QB = 32;             // queries per block
constexpr int SB = 64;             // slots per block
constexpr int TX = 16;             // threads along slots
constexpr int TY = 16;             // threads along queries
constexpr int THREADS = TX * TY;   // 256
constexpr int QPT = QB / TY;       // queries per thread
constexpr int SPT = SB / TX;       // slots per thread

__global__ void __launch_bounds__(THREADS)
tiles_resid_kernel(const int32_t* __restrict__ payload,     // (N_pad, D) int8 as words
                   const uint8_t* __restrict__ local,       // (N_pad,)
                   const __nv_bfloat16* __restrict__ ct,    // (n_tiles, W, D)
                   const __nv_bfloat16* __restrict__ qbf,   // (Q_pad, D)
                   const int32_t* __restrict__ q8,          // (Q_pad, D) int8 as words
                   const float* __restrict__ row_scale,     // (Q_pad,)
                   const int32_t* __restrict__ tile_table,  // (n_qt, P)
                   const int32_t* __restrict__ valid_end,   // (n_tiles, W)
                   float* __restrict__ out_v,               // (Q_pad, L)
                   int32_t* __restrict__ out_i,             // (Q_pad, L)
                   int tile_q, int p_entries, int tile_n, int l_buckets,
                   int d, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = d / 4;
  const int stride = d4 + 1;  // words per staged row
  int32_t* rows_s = reinterpret_cast<int32_t*>(smem);  // SB * stride
  int32_t* q8_s = rows_s + SB * stride;                // QB * stride
  float* qc_s = reinterpret_cast<float*>(q8_s + QB * stride);  // W * QB
  float* rs_s = qc_s + w * QB;                                 // QB
  int32_t* ve_s = reinterpret_cast<int32_t*>(rs_s + QB);       // SB
  int32_t* loc_s = ve_s + SB;                                  // SB
  int32_t* wrange_s = loc_s + SB;                              // lo, hi

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qblocks = (tile_q + QB - 1) / QB;
  const int qt = blockIdx.y / qblocks;
  const int q_lo = qt * tile_q + (blockIdx.y % qblocks) * QB;
  const int nq_blk = min(QB, (qt + 1) * tile_q - q_lo);
  const int b0 = blockIdx.x * SB;
  const int r_per = tile_n / l_buckets;

  // the block's queries stay in shared memory for the whole table walk
  for (int i = tid; i < QB * d4; i += THREADS) {
    const int qi = i / d4, k = i % d4;
    q8_s[qi * stride + k] = qi < nq_blk ? q8[(size_t)(q_lo + qi) * d4 + k] : 0;
  }
  for (int i = tid; i < QB; i += THREADS) {
    rs_s[i] = i < nq_blk ? row_scale[q_lo + i] : 0.f;
  }

  float best_v[QPT][SPT];
  int best_i[QPT][SPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      best_v[i][j] = -INFINITY;
      best_i[i][j] = 0;
    }

  for (int p = 0; p < p_entries; ++p) {
    const int t = tile_table[(size_t)qt * p_entries + p];
    const long long base = (long long)t * tile_n;
    float tmx[QPT][SPT];
    int tr[QPT][SPT];
    for (int r = 0; r < r_per; ++r) {
      const long long row0 = base + (long long)r * l_buckets + b0;
      __syncthreads();  // the previous step is done with the staged rows
      if (tid == 0) {
        wrange_s[0] = INT_MAX;
        wrange_s[1] = -1;
      }
      __syncthreads();
      for (int i = tid; i < SB * d4; i += THREADS) {
        const int ri = i / d4, k = i % d4;
        rows_s[ri * stride + k] =
            b0 + ri < l_buckets ? payload[(size_t)(row0 + ri) * d4 + k] : 0;
      }
      if (tid < SB) {
        int li = 0, ve = 0;
        if (b0 + tid < l_buckets) {
          li = local[row0 + tid];
          ve = valid_end[(size_t)t * w + li];
          atomicMin(&wrange_s[0], li);
          atomicMax(&wrange_s[1], li);
        }
        loc_s[tid] = li;
        ve_s[tid] = ve;
      }
      __syncthreads();

      // centroid term for the lists of the staged rows: one warp per
      // (list, query) pair, bf16 products summed in f32
      const int wlo = wrange_s[0], whi = wrange_s[1];
      const int npairs = whi >= wlo ? (whi - wlo + 1) * QB : 0;
      for (int pr = warp; pr < npairs; pr += THREADS / 32) {
        const int qi = pr % QB, wi = wlo + pr / QB;
        float acc = 0.f;
        if (qi < nq_blk) {
          const __nv_bfloat162* qv =
              reinterpret_cast<const __nv_bfloat162*>(qbf + (size_t)(q_lo + qi) * d);
          const __nv_bfloat162* cv =
              reinterpret_cast<const __nv_bfloat162*>(ct + ((size_t)t * w + wi) * d);
          for (int k = lane; k < d / 2; k += 32) {
            const float2 a = __bfloat1622float2(qv[k]);
            const float2 c = __bfloat1622float2(cv[k]);
            acc = fmaf(a.x, c.x, acc);  // bf16 products are exact in f32
            acc = fmaf(a.y, c.y, acc);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        }
        if (lane == 0) qc_s[(wi - wlo) * QB + qi] = acc;
      }
      __syncthreads();

      // residual term: exact int8 dots
      int acc[QPT][SPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) acc[i][j] = 0;
      for (int k = 0; k < d4; ++k) {
        int a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q8_s[(ty + TY * i) * stride + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = rows_s[(tx + TX * j) * stride + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }

#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const int qi = ty + TY * i, sj = tx + TX * j;
          float s = -INFINITY;
          if (qi < nq_blk && b0 + sj < l_buckets && row0 + sj < (long long)ve_s[sj]) {
            const float c = qc_s[(loc_s[sj] - wlo) * QB + qi];
            s = __fadd_rn(c, __fmul_rn(rs_s[qi], (float)acc[i][j]));
          }
          if (r == 0 || s > tmx[i][j]) {  // within a tile the smallest r wins ties
            tmx[i][j] = s;
            tr[i][j] = r;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        if (tmx[i][j] > best_v[i][j]) {  // strict: the earlier entry wins ties
          best_v[i][j] = tmx[i][j];
          best_i[i][j] = (int)(base + (long long)tr[i][j] * l_buckets + b0 + tx + TX * j);
        }
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int qi = ty + TY * i, b = b0 + tx + TX * j;
      if (qi < nq_blk && b < l_buckets) {
        out_v[(size_t)(q_lo + qi) * l_buckets + b] = best_v[i][j];
        out_i[(size_t)(q_lo + qi) * l_buckets + b] = best_i[i][j];
      }
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for row width d and window w.
int cvdb_tiles_resid_smem_bytes(int d, int w) {
  const int stride = d / 4 + 1;
  return (SB + QB) * stride * 4 + w * QB * 4 + QB * 4 + SB * 4 * 2 + 2 * 4;
}

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the scan on `stream`; returns cudaGetLastError() after the launch.
int cvdb_tiles_resid(const void* payload, const void* local, const void* centroid_tiles,
                     const void* q_bf16, const void* q8, const void* row_scale,
                     const void* tile_table, const void* valid_end, void* out_v,
                     void* out_i, int n_qt, int tile_q, int p_entries, int tile_n,
                     int l_buckets, int d, int w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = cvdb_tiles_resid_smem_bytes(d, w);
  err = cudaFuncSetAttribute(tiles_resid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qblocks = (tile_q + QB - 1) / QB;
  const dim3 grid((l_buckets + SB - 1) / SB, n_qt * qblocks);
  tiles_resid_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(payload), static_cast<const uint8_t*>(local),
      static_cast<const __nv_bfloat16*>(centroid_tiles),
      static_cast<const __nv_bfloat16*>(q_bf16), static_cast<const int32_t*>(q8),
      static_cast<const float*>(row_scale), static_cast<const int32_t*>(tile_table),
      static_cast<const int32_t*>(valid_end), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), tile_q, p_entries, tile_n, l_buckets, d, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
