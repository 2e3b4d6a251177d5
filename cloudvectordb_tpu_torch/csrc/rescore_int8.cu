// The int8 rescore of the PQ route for Hopper (sm_90a), plain C interface:
// one gather-and-dot kernel that scores each query's K5 candidates against
// their int8 refine rows.
//
// It replaces no Pallas kernel. The JAX reference leaves this step to XLA
// (cloudvectordb_tpu/index/ivf_band.py:146-170: a gather of the candidates'
// int8 rows, a cast and an einsum); the port's plain version of the same
// contract is ops/rescore.py::rescore_int8_reference, which gathers the rows,
// casts them to an f32 (sub, k_cand, D) block and calls torch.bmm. On the
// card that block made the step move about eleven times the bytes it needs
// (the gather's write, the cast's read and f32 write, the product's read).
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes.
//
// What it computes, for query b (planner order) and candidate slot j, with
// row = cand[b, j] (the caller's arena row, already clamped to [0, n_rows))
// and r = rows[row] (D int8 values, D a multiple of 4):
//   - unfilled slot (v[b, j] == -inf, K5's empty slot): -inf; r is not read;
//   - residual rows, ip: (sum_d bf16(q[b, d]) * r[d]) * scale + dots[order[b],
//     list], where list = window[row / tile_n, local[row]] is the row's
//     coarse list and dots[order[b]] the caller-order query's exact
//     centroid products; each product is exact in f32 (8 significant bits
//     times 8), so only the order of the f32 sum differs from the plain
//     version;
//   - residual rows, l2: the same, less 0.5 * ((|c|^2 + (2 scale) (c . r)) +
//     scale^2 |r|^2) before the centroid term is added, c the list's f32
//     centroid; the three sums are taken in f32 in the same pass;
//   - whole rows, ip: sum_d q[b, d] * (r[d] * scale) in f32 (q not rounded to
//     bf16; r * scale rounded to f32 first, as the plain version's block);
//   - whole rows, l2: less 0.5 * sum_d (r[d] * scale)^2.
// The epilogue's multiplies and adds are the plain version's, in its order
// and without contraction; no sum is taken in a lower precision. One
// instantiation per (residual, l2), picked by the wrapper from the index's
// state.
//
// What bounds it. B * k_cand * D int8 bytes, each candidate's row read once
// (6.45 GB at B 4096, k_cand 2050, D 768: 1.93 ms at 3.35 TB/s), against one
// multiply-add a byte: the kernel is bound by bytes. So:
//   - rows in flight: a block is one query and 8 warps; a warp scores
//     ROWS = 4 candidates at once, each lane loading WORDS = 3 four-byte
//     words of each a pass (128 contiguous bytes a warp load; two passes at
//     D 768), all 12 loads issued before any is used: 1.5 KB a warp, about
//     48 KB an SM at four blocks an SM, against the ~15 KB an SM that
//     3.35 TB/s needs over its latency (6 words a pass timed the same for
//     residual ip, up to 7% faster for whole rows, and spilled in one
//     instantiation: A/B on an H100, PERF.md);
//   - no I2F an element: a word's four bytes become floats by XOR 0x80
//     (offset binary), one byte permute each into the mantissa of 2^23 and
//     one exact subtract (2^23 + 128), then one FMA with the query value
//     held in shared memory (staged once a block, bf16-rounded for residual
//     rows); I2F would run at a quarter of that rate, as long as the bytes;
//   - nothing but the row loads waits on device memory in the loop: a
//     chunk of up to CHUNK of the query's slots is staged in shared memory
//     first, every thread taking a few slots with their loads in flight
//     together (the candidate's arena row, or -1 where the slot is
//     unfilled; for residual rows the list lookup local -> window -> dots,
//     three dependent loads, and the list); loaded a row at a time as a
//     chain of dependent loads, the lookups made the residual ip kernel 11%
//     slower and the residual l2 one 38% (A/B on an H100, PERF.md);
//   - each warp's four sums are finished by a shuffle butterfly and written
//     by lanes 0-3 as four consecutive floats;
//   - the grid runs in planner order, so queries of one table group, which
//     share K5's tiles and so many candidate rows, run together and the
//     50 MB L2 serves their repeated rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 8;    // a block: one query, 8 warps
constexpr int ROWS = 4;     // candidates a warp scores at once
constexpr int WORDS = 3;    // 4-byte words of a row a lane loads in one pass
constexpr int CHUNK = 4096; // slots of a query staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int8_t* rows;       // (n_rows, d) int8 refine rows
  const int64_t* cand;      // (b, kc) arena row of each candidate, in [0, n_rows)
  const float* v;           // (b, kc) K5's slot values, -inf where unfilled
  const float* q;           // (b, d) f32 queries, planner order
  const uint8_t* local;     // (>= n_rows,) local list byte of each arena row (residual)
  const int64_t* window;    // (n_tiles, w) list id of each tile's local byte (residual)
  const float* dots;        // (b, nlist) query . centroid, caller order (residual)
  const int64_t* order;     // (b,) caller index of each planner-order query (residual)
  const float* cents;       // (nlist, d) f32 centroids (residual l2)
  float* out;               // (b, kc)
  int kc, d, tile_n, w, nlist;
  int chunk;                // slots staged in shared memory at a time
  float scale, two_scale, scale_sq;
};

// Four int8 values of a word, exactly, as floats: the offset-binary byte in
// the low mantissa bits of 2^23, less 2^23 + 128.
__device__ __forceinline__ void widen(uint32_t x, float (&f)[4]) {
  const uint32_t u = x ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <bool RESID, bool L2>
__global__ void __launch_bounds__(WARPS * 32, L2 ? 2 : 4) rescore_kernel(const Args a) {
  // shared: the query (d / 4 words), then a chunk's staged slots: arena
  // row (-1: unfilled), centroid term, list
  extern __shared__ float4 qs[];
  const int nwords = a.d / 4;
  long long* srow = reinterpret_cast<long long*>(qs + nwords);
  float* sterm = reinterpret_cast<float*>(srow + a.chunk);
  int* slist = reinterpret_cast<int*>(sterm + a.chunk);

  const int b = blockIdx.x;
  const float* qb = a.q + static_cast<long long>(b) * a.d;
  for (int wi = threadIdx.x; wi < nwords; wi += blockDim.x) {
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = qb[4 * wi + k];
      e[k] = RESID ? __bfloat162float(__float2bfloat16_rn(x)) : x;
    }
    qs[wi] = make_float4(e[0], e[1], e[2], e[3]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(b) * a.kc;
  const float* dots_b = RESID ? a.dots + a.order[b] * static_cast<long long>(a.nlist) : nullptr;

  for (int c0 = 0; c0 < a.kc; c0 += a.chunk) {
    const int ch = min(a.chunk, a.kc - c0);
    // stage the chunk's slots: every thread a few, their loads in flight together
#pragma unroll 4
    for (int t = threadIdx.x; t < ch; t += blockDim.x) {
      const long long row = a.cand[base + c0 + t];
      const bool live = a.v[base + c0 + t] > -INFINITY;
      srow[t] = live ? row : -1;
      if (RESID && live) {
        const int list = static_cast<int>(a.window[(row / a.tile_n) * a.w + a.local[row]]);
        sterm[t] = dots_b[list];
        if (L2) slist[t] = list;
      }
    }
    __syncthreads();

    for (int j0 = warp * ROWS; j0 < ch; j0 += WARPS * ROWS) {
      long long row[ROWS];
      bool on[ROWS];
      const float* cent[ROWS];  // residual l2: the candidate's list centroid
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const long long r = j0 + u < ch ? srow[j0 + u] : -1;
        on[u] = r >= 0;
        row[u] = on[u] ? r : 0;
        if (RESID && L2)
          cent[u] = a.cents + static_cast<long long>(on[u] ? slist[j0 + u] : 0) * a.d;
      }
      float dot[ROWS], cr[ROWS], cc[ROWS], sq[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) dot[u] = cr[u] = cc[u] = sq[u] = 0.f;

      for (int w0 = 0; w0 < nwords; w0 += 32 * WORDS) {
        uint32_t x[ROWS][WORDS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int8_t* rp = a.rows + row[u] * a.d;
#pragma unroll
          for (int i = 0; i < WORDS; ++i) {
            const int wi = w0 + i * 32 + lane;
            x[u][i] = (on[u] && wi < nwords)
                          ? __ldg(reinterpret_cast<const uint32_t*>(rp) + wi) : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
          const int wi = w0 + i * 32 + lane;
          if (wi >= nwords) continue;
          const float4 q4 = qs[wi];
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            float f[4];
            widen(x[u][i], f);
            if (RESID) {
#pragma unroll
              for (int k = 0; k < 4; ++k) dot[u] = fmaf(qv[k], f[k], dot[u]);
              if (L2 && on[u]) {
                const float4 c4 = __ldg(reinterpret_cast<const float4*>(cent[u]) + wi);
                const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  cc[u] = fmaf(c[k], c[k], cc[u]);
                  cr[u] = fmaf(c[k], f[k], cr[u]);
                  sq[u] = fmaf(f[k], f[k], sq[u]);
                }
              }
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float t = __fmul_rn(f[k], a.scale);
                dot[u] = fmaf(qv[k], t, dot[u]);
                if (L2) sq[u] = fmaf(t, t, sq[u]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        dot[u] = warp_sum(dot[u]);
        if (L2) {
          sq[u] = warp_sum(sq[u]);
          if (RESID) {
            cc[u] = warp_sum(cc[u]);
            cr[u] = warp_sum(cr[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (lane != u || j0 + u >= ch) continue;
        float ex = -INFINITY;
        if (on[u]) {
          if (RESID) {
            ex = __fmul_rn(dot[u], a.scale);
            if (L2) {
              const float t = __fadd_rn(__fadd_rn(cc[u], __fmul_rn(a.two_scale, cr[u])),
                                        __fmul_rn(a.scale_sq, sq[u]));
              ex = __fsub_rn(ex, __fmul_rn(0.5f, t));
            }
            ex = __fadd_rn(ex, sterm[j0 + u]);
          } else {
            ex = dot[u];
            if (L2) ex = __fsub_rn(ex, __fmul_rn(0.5f, sq[u]));
          }
        }
        a.out[base + c0 + j0 + u] = ex;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged slots
  }
}

// Shared memory a block needs: the query, and a chunk's staged slots.
int smem_bytes(int d, int chunk) { return d / 4 * 16 + chunk * 16; }

template <bool RESID, bool L2>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const int smem = smem_bytes(a.d, a.chunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rescore_kernel<RESID, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  rescore_kernel<RESID, L2><<<b, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block needs.
int cvdb_rescore_int8_smem_bytes(int d, int kc) {
  return smem_bytes(d, kc < CHUNK ? kc : CHUNK);
}

// Launches the rescore on `stream`; returns the launch's cudaGetLastError().
// `residual` 0 leaves local, window, dots, order and cents unread; `l2` 0
// leaves cents unread. d must be a multiple of 4 and every live slot's row
// in [0, n_rows): the wrapper checks the first, the caller owns the second.

int cvdb_rescore_int8(const void* rows, const void* cand, const void* v,
                      const void* q, const void* local, const void* window, const void* dots,
                      const void* order, const void* cents, void* out, int b, int kc, int d,
                      int tile_n, int w, int nlist, float scale, float two_scale,
                      float scale_sq, int residual, int l2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int8_t*>(rows), static_cast<const int64_t*>(cand),
               static_cast<const float*>(v), static_cast<const float*>(q),
               static_cast<const uint8_t*>(local), static_cast<const int64_t*>(window),
               static_cast<const float*>(dots), static_cast<const int64_t*>(order),
               static_cast<const float*>(cents), static_cast<float*>(out), kc, d,
               tile_n, w, nlist, kc < CHUNK ? kc : CHUNK, scale, two_scale, scale_sq};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual) {
    err = l2 ? launch<true, true>(a, b, s) : launch<true, false>(a, b, s);
  } else {
    err = l2 ? launch<false, true>(a, b, s) : launch<false, false>(a, b, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
