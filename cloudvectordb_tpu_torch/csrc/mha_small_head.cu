// K4: masked multi-head attention over head-packed rows, forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// Replaces cloudvectordb_tpu/ops/pallas_attn.py:109 mha_small_head (forward
// body _fwd_kernel :40, backward body _bwd_kernel :61, custom VJP :119-137).
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/attn.py (_fwd_plain, _bwd_plain).
//
// What it computes. q, k and v are (B, L, H*D) rows in f32 or bf16, head h
// in columns h*D .. (h+1)*D; mask is (B, L) int32 over keys. Per sequence b
// and head h, in f32: s = (q_h * scale) k_h^T; keys with mask == 0 score
// -1e30 (not -inf: a fully masked row then gives the mean of v over all L
// keys, as the reference does); p = softmax(s); o_h = p v_h, stored in q's
// type. The backward recomputes p and writes, in q's type,
//   dv_h = p^T do_h,  dp = do_h v_h^T,  ds = p * (dp - rowsum(dp * p)),
//   dq_h = scale * ds k_h,  dk_h = ds^T (q_h * scale).
//
// Two designs, by row type.
//
// bf16 rows (the encoder's training and encode type) run on the tensor
// cores: mma.sync.m16n8k16 bf16 x bf16 -> f32, operands from shared memory
// through ldmatrix (.trans where the product needs the other orientation),
// rows staged as bf16 by 16-byte cp.async into tiles padded by 8 values a
// row, so the 8 row addresses of one ldmatrix fall in distinct banks. A
// warp owns 16 rows. The forward and the L 128 backward are persistent: as
// many blocks as fit the card, block i taking the items i, i + gridDim.x,
// ..., with the next item's loads in flight while one is computed (one
// block per item left each SM idle while its first loads flew).
//   forward (mha_fwd_tc_kernel): an item is one (sequence, head) and 128
//       queries, 8 warps; keys stream in chunks of 64, double-buffered.
//       S = Q K^T in f32, times scale, masked to -1e30; an online softmax in
//       registers (running max and sum, rescaled once a chunk); O += P V
//       with P rounded to bf16 in registers (the f32 accumulator fragment of
//       S is the A fragment of the second product). After the first chunk,
//       a 64-key chunk whose keys are all masked is neither loaded nor
//       computed when the sequence has a live key: exp(-1e30 - m) is exactly
//       0 in f32, so such keys add nothing. A fully masked sequence runs
//       every chunk and gets the mean of v. Writes o and the row max and sum.
//   backward at L 128 (mha_bwd_tc_kernel), one launch, 16 warps: an item is
//       one (sequence, head), whose Q, K, V and dO, mask and row statistics
//       sit in shared memory. Warps 2p and 2p + 1 own queries 16p..16p+15,
//       each against one half of the keys (so S and dP take 64 registers a
//       thread, not 128): S and dP = dO V^T on the tensor cores,
//       P = exp(S - m) / l from the forward's statistics, delta =
//       rowsum(dP * P) in f32 (as the plain version computes it; O exists
//       only in bf16, so not rowsum(dO * O)), summed over the two halves in
//       order through shared memory, dS = P (dP - delta). P and dS go to
//       shared memory as bf16; each warp of the pair then takes dQ = scale
//       dS K for one half of the head's columns. After one barrier the pair
//       owns keys 16p..16p+15, each warp one half of the columns: dV = P^T
//       dO, dK = scale dS^T Q (ldmatrix.trans gives P^T and dS^T). Five
//       products, S computed once.
//   backward at L 256 and 512: two launches, both on the tensor cores.
//       mha_bwd_dq_tc_kernel owns 128 queries and sweeps the keys twice in
//       chunks of 64 (delta first, then dS and dQ), writing dQ and delta;
//       mha_bwd_dkdv_tc_kernel owns 128 keys and sweeps the queries in chunks
//       of 64, forming S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
//       are accumulator fragments that feed dV and dK directly.
// P and dS round to bf16 before their second products, as SDPA's kernels
// do; every sum runs in one fixed order with no atomics, so two runs give
// bit-identical gradients. Why mma.sync and not wgmma: at the training
// shape the forward's 3.9e10 FLOP take ~0.07 ms even at mma.sync's ~550
// TFLOP/s, under the 0.18 ms byte bound, and a warp's 16-row tile keeps the
// softmax in the registers of the warp that computed the scores.
//
// f32 rows keep the CUDA-core kernels below (mha_fwd_kernel,
// mha_bwd_dq_kernel, mha_bwd_dkdv_kernel): their contract is f32 within
// 2e-5 of the plain version, and TF32 tensor cores keep about three
// decimal digits, which cannot hold it.
//
// The f32 kernels. The TPU kernel holds one whole sequence in VMEM
// per grid step and loops over heads. Here one block owns 128 rows (queries
// for the forward and dq, keys for dk/dv) of one (sequence, head) and loops
// over the other side in tiles of 32 staged in shared memory as f32. A row
// is owned by D/16 adjacent threads, each holding 16 of its D values in
// registers; a dot product is their partial sums (four independent chains
// each) joined by warp shuffles, so every thread of the group sees the same
// score and no scores are kept in memory. The forward runs an online
// softmax (running max m and sum l per row, rescaled once per key tile) and
// writes m and l per row, f32 (B, H, L). The backward takes
// p = exp(s - m) * (1 / l) from them, the reference's normalisation of the
// same scores up to one rounding of the reciprocal, and runs two kernels,
// with no atomics, so every gradient is summed in one fixed order:
//   dq  per 128 queries, looping over keys: rowsum(dp * p) and
//       sum_j p dp k_j and sum_j p k_j in one pass, so that
//       dq = scale * (sum_j p dp k_j - rowsum * sum_j p k_j); it also writes
//       rowsum (B, H, L) for the second kernel. (A pre-pass for rowsum would
//       cost a second sweep; do . o would need o in f32, which the forward
//       does not keep for bf16 rows.) The cancellation in the last step
//       costs ~1e-7 of |sum_j p dp k_j| in f32, far inside the tolerances
//       of the checks (2e-5 f32, bf16 rounding for bf16).
//   dkdv per 128 keys, looping over queries: dv_j += p do_i and
//       dk_j += ds (q_i * scale), with rowsum read back per query.
//
// What bounds it. At the training shape (B 1536, L 128, H 12, D 32, bf16)
// the forward must read q, k, v and write o, 604 MB, 0.18 ms at 3.35 TB/s,
// and do 3.9e10 FLOP, 0.04 ms at the tensor cores' 989 TFLOP/s: the work is
// memory-bound. The backward reads q, k, v and do and writes dq, dk and dv
// (1.06 GB, 0.32 ms) for ~9.7e10 FLOP. The tensor-core kernels take the
// products off the issue slots; what is left there bounds them at about
// 2.2x (forward) and 2.7x (backward) the byte bound: the softmax's work per
// score (scale, mask select, max, exp, sum, and in the backward dS), about
// eight instructions a score where the forward's two products take one
// HMMA per 32 scores at d 32, and the item stream's
// integer work, issued by four warps per scheduler (PERF.md). The f32
// kernels run f32 FMAs on the
// CUDA cores (33.5 T FMA/s at most) fed by broadcast shared-memory loads,
// so they are bound by the issue rate of those instructions and by the
// latency of each key's chain (dot, shuffle, exp, update).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int ROWS = 128;   // rows a block owns: queries (fwd, dq) or keys (dk/dv)
constexpr int TILE = 32;    // rows of the other side staged per step
constexpr int SLICE = 16;   // head values one thread holds
constexpr int PAD = 20;     // floats between slices in shared memory: the
                            // 2 or 4 slices of one row sit in distinct banks
constexpr float MASKED = -1e30f;
// blocks per SM the backward kernels are compiled for: 16 warps, so at
// most 128 registers a thread
#define BWD_BLOCKS(D) (512 / (ROWS * ((D) / SLICE)))

enum Elem { F32 = 0, BF16 = 1 };

__device__ __forceinline__ void load_slice(const float* p, float (&x)[SLICE]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 4; ++c) {
    const float4 w = p4[c];
    x[4 * c] = w.x;
    x[4 * c + 1] = w.y;
    x[4 * c + 2] = w.z;
    x[4 * c + 3] = w.w;
  }
}

__device__ __forceinline__ void store_slice(float* p, const float (&x)[SLICE]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 4; ++c)
    p4[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Four independent partial sums: a chain of 4 dependent FMAs, not 16.
__device__ __forceinline__ float dot_slice(const float (&a)[SLICE], const float (&b)[SLICE]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < SLICE; ++e) s[e % 4] = fmaf(a[e], b[e], s[e % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Sum over the G adjacent lanes that own one row: every lane of the group
// gets the same bits (each step adds the same two values, in either order).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage TILE rows (stride `stride` elements, D values each, times `mul`) as
// f32 into dst[TILE][G][PAD].
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride, float mul) {
  constexpr int G = D / SLICE;
  for (int c = threadIdx.x; c < TILE * G; c += blockDim.x) {
    const int r = c / G, t = c % G;
    float x[SLICE];
    load_slice(src + r * stride + t * SLICE, x);
#pragma unroll
    for (int e = 0; e < SLICE; ++e) x[e] *= mul;
    store_slice(dst + (r * G + t) * PAD, x);
  }
}

struct Rows {  // where this thread's row and slice sit
  int b, h, row, t;
  long seq, hd, head;
};

template <int D>
__device__ __forceinline__ Rows rows_of(int L, int H) {
  constexpr int G = D / SLICE;
  const int tiles = L / ROWS;
  Rows r;
  r.b = blockIdx.x / tiles;
  r.row = (blockIdx.x % tiles) * ROWS + threadIdx.x / G;
  r.t = threadIdx.x % G;
  r.h = blockIdx.y;
  r.hd = static_cast<long>(H) * D;
  r.seq = static_cast<long>(r.b) * L;
  r.head = static_cast<long>(r.h) * D + r.t * SLICE;
  return r;
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE))
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ mask, T* __restrict__ o, float* __restrict__ row_max,
               float* __restrict__ row_sum, int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float ks[TILE * G * PAD];
  __shared__ __align__(16) float vs[TILE * G * PAD];
  __shared__ int live[TILE];
  const Rows r = rows_of<D>(L, H);
  const long key0 = r.seq * r.hd + static_cast<long>(r.h) * D;

  float qr[SLICE], acc[SLICE];
  load_slice(q + (r.seq + r.row) * r.hd + r.head, qr);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    qr[e] *= scale;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, k + key0 + j0 * r.hd, r.hd, 1.f);
    stage<D>(vs, v + key0 + j0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) live[threadIdx.x] = mask[r.seq + j0 + threadIdx.x];
    __syncthreads();
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float kr[SLICE];
      load_slice(ks + (j * G + r.t) * PAD, kr);
      const float dot = group_sum<G>(dot_slice(qr, kr));
      s[j] = live[j] > 0 ? dot : MASKED;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int e = 0; e < SLICE; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      float vr[SLICE];
      load_slice(vs + (j * G + r.t) * PAD, vr);
#pragma unroll
      for (int e = 0; e < SLICE; ++e) acc[e] = fmaf(p, vr[e], acc[e]);
    }
    m = m_new;
  }
#pragma unroll
  for (int e = 0; e < SLICE; ++e) acc[e] = acc[e] / l;
  store_slice(o + (r.seq + r.row) * r.hd + r.head, acc);
  if (r.t == 0) {
    const long stat = (static_cast<long>(r.b) * H + r.h) * L + r.row;
    row_max[stat] = m;
    row_sum[stat] = l;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE), BWD_BLOCKS(D))
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ mask, const T* __restrict__ dout,
                  const float* __restrict__ row_max, const float* __restrict__ row_sum,
                  T* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float ks[TILE * G * PAD];
  __shared__ __align__(16) float vs[TILE * G * PAD];
  __shared__ int live[TILE];
  const Rows r = rows_of<D>(L, H);
  const long key0 = r.seq * r.hd + static_cast<long>(r.h) * D;
  const long stat = (static_cast<long>(r.b) * H + r.h) * L + r.row;
  const float m = row_max[stat], inv_l = 1.f / row_sum[stat];

  float qr[SLICE], dor[SLICE], pdpk[SLICE], pk[SLICE];
  load_slice(q + (r.seq + r.row) * r.hd + r.head, qr);
  load_slice(dout + (r.seq + r.row) * r.hd + r.head, dor);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    qr[e] *= scale;
    pdpk[e] = 0.f;
    pk[e] = 0.f;
  }
  float rowsum = 0.f;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();
    stage<D>(ks, k + key0 + j0 * r.hd, r.hd, 1.f);
    stage<D>(vs, v + key0 + j0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) live[threadIdx.x] = mask[r.seq + j0 + threadIdx.x];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < TILE; ++j) {
      float kr[SLICE], vr[SLICE];
      load_slice(ks + (j * G + r.t) * PAD, kr);
      load_slice(vs + (j * G + r.t) * PAD, vr);
      const float dot = group_sum<G>(dot_slice(qr, kr));
      const float s = live[j] > 0 ? dot : MASKED;
      const float p = expf(s - m) * inv_l;
      const float dp = group_sum<G>(dot_slice(dor, vr));
      const float pdp = p * dp;
      rowsum += pdp;
#pragma unroll
      for (int e = 0; e < SLICE; ++e) {
        pdpk[e] = fmaf(pdp, kr[e], pdpk[e]);
        pk[e] = fmaf(p, kr[e], pk[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < SLICE; ++e) pdpk[e] = scale * (pdpk[e] - rowsum * pk[e]);
  store_slice(dq + (r.seq + r.row) * r.hd + r.head, pdpk);
  if (r.t == 0) delta[stat] = rowsum;
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE), BWD_BLOCKS(D))
mha_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ mask, const T* __restrict__ dout,
                    const float* __restrict__ row_max, const float* __restrict__ row_sum,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float qs[TILE * G * PAD];
  __shared__ __align__(16) float dos[TILE * G * PAD];
  __shared__ float sm[TILE], sl[TILE], sd[TILE];  // row max, 1 / row sum, rowsum(dp * p)
  const Rows r = rows_of<D>(L, H);  // r.row is a key here
  const long query0 = r.seq * r.hd + static_cast<long>(r.h) * D;
  const long stat0 = (static_cast<long>(r.b) * H + r.h) * L;
  const bool allow = mask[r.seq + r.row] > 0;

  float kr[SLICE], vr[SLICE], dkr[SLICE], dvr[SLICE];
  load_slice(k + (r.seq + r.row) * r.hd + r.head, kr);
  load_slice(v + (r.seq + r.row) * r.hd + r.head, vr);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    dkr[e] = 0.f;
    dvr[e] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += TILE) {
    __syncthreads();
    stage<D>(qs, q + query0 + i0 * r.hd, r.hd, scale);
    stage<D>(dos, dout + query0 + i0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) {
      sm[threadIdx.x] = row_max[stat0 + i0 + threadIdx.x];
      sl[threadIdx.x] = 1.f / row_sum[stat0 + i0 + threadIdx.x];
      sd[threadIdx.x] = delta[stat0 + i0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < TILE; ++i) {
      float qv[SLICE], dov[SLICE];
      load_slice(qs + (i * G + r.t) * PAD, qv);
      load_slice(dos + (i * G + r.t) * PAD, dov);
      const float dot = group_sum<G>(dot_slice(qv, kr));
      const float s = allow ? dot : MASKED;
      const float p = expf(s - sm[i]) * sl[i];
      const float dp = group_sum<G>(dot_slice(dov, vr));
      const float ds = p * (dp - sd[i]);
#pragma unroll
      for (int e = 0; e < SLICE; ++e) {
        dvr[e] = fmaf(p, dov[e], dvr[e]);
        dkr[e] = fmaf(ds, qv[e], dkr[e]);
      }
    }
  }
  store_slice(dk + (r.seq + r.row) * r.hd + r.head, dkr);
  store_slice(dv + (r.seq + r.row) * r.hd + r.head, dvr);
}

// ---- bf16 rows on the tensor cores -----------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 256;  // 8 warps of 16 rows: a block owns ROWS rows
constexpr int CHUNK = 64;        // keys (or queries) streamed per step
constexpr int L_MAX = 512;
constexpr int ROW_PAD = 8;                // bf16 values of padding a shared-memory row
constexpr int P_STRIDE = ROWS + ROW_PAD;  // row stride of the P and dS tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of D values (global row stride `stride` elements) into a
// shared tile of row stride D + ROW_PAD, one 16-byte copy per thread and step.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, long stride, int rows) {
  constexpr int P = D / 8;
  for (int i = threadIdx.x; i < rows * P; i += blockDim.x) {
    const int r = i / P, c = i % P;
    cp_async16(dst + r * (D + ROW_PAD) + c * 8, src + r * stride + c * 8);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Barrier of the 64 threads of warps 2p and 2p + 1 (ids 1 .. 8; 0 is
// __syncthreads).
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(p + 1) : "memory");
}

// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 g + t: an A fragment a[4]
// holds rows g and g + 8 at columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8,
// 2t + 9 (a[2], a[3]); a B fragment (b0, b1) column g at rows 2t, 2t + 1 and
// 2t + 8, 2t + 9; an accumulator c[4] rows g (c[0], c[1]) and g + 8 (c[2],
// c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the 16 rows from row0 of a shared tile of D columns.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int row0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (row0 + lane % 8 + 8 * ((lane / 8) % 2)) * (D + ROW_PAD) + 8 * (lane / 16);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(a[ks], p + 16 * ks);
}

// c = a t^T: 16 rows of D values (A fragments) against NT * 8 rows of a
// shared tile from row n0; c[j] holds tile rows n0 + 8j .. n0 + 8j + 7.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int n0) {
  constexpr int S = D + ROW_PAD;
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (n0 + lane % 8 + 8 * (lane / 16)) * S + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, p + 16 * np * S + 16 * ks);
      mma_bf16(c[2 * np], a[ks], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// c += a t: 16 rows of KT * 16 values (A fragments) times KT * 16 rows of a
// shared tile of D columns from row k0 (ldmatrix.trans gives the B side).
template <int D, int KT>
__device__ __forceinline__ void mma_at(float (&c)[D / 8][4], const uint32_t (&a)[KT][4],
                                       const bf16* tile, int k0) {
  constexpr int S = D + ROW_PAD;
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * S + 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, p + 16 * kk * S + 16 * dp);
      mma_bf16(c[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(c[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// c += a b over KT * 16 of the k dimension, both from shared memory: a is
// the 16 rows a0 .. a0 + 15 of tile at (row stride as), or with TRANS_A the
// transpose of its 16 columns a0 .. a0 + 15; b is the k rows of tile bt
// (row stride bs), columns col0 .. col0 + NC.
template <int KT, int NC, bool TRANS_A>
__device__ __forceinline__ void mma_smem(float (&c)[NC / 8][4], const bf16* at, int as, int a0,
                                         const bf16* bt, int bs, int col0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const bf16* pa = TRANS_A ? at + (8 * (m / 2) + lane % 8) * as + a0 + 8 * (m % 2)
                           : at + (a0 + lane % 8 + 8 * (m % 2)) * as + 8 * (m / 2);
  const bf16* pb = bt + (lane % 8 + 8 * (m % 2)) * bs + col0 + 8 * (m / 2);
#pragma unroll 2
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    if (TRANS_A)
      ldsm_x4_t(a, pa + 16 * kk * as);
    else
      ldsm_x4(a, pa + 16 * kk);
    if constexpr (NC == 8) {
      uint32_t b[2];
      ldsm_x2_t(b, pb + 16 * kk * bs);
      mma_bf16(c[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int dp = 0; dp < NC / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, pb + 16 * kk * bs + 16 * dp);
        mma_bf16(c[2 * dp], a, b[0], b[1]);
        mma_bf16(c[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// The accumulators of 16 rows x NT * 8 columns as A fragments (bf16).
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The accumulators of 16 rows, row g times mul0 and row g + 8 times mul1,
// as bf16 at out (row stride `stride` elements; global or shared).
template <int NT>
__device__ __forceinline__ void store_acc(bf16* out, long stride, const float (&c)[NT][4],
                                          float mul0, float mul1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(out + g * stride + 8 * j + 2 * t) =
        pack_bf16(c[j][0] * mul0, c[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(out + (g + 8) * stride + 8 * j + 2 * t) =
        pack_bf16(c[j][2] * mul1, c[j][3] * mul1);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&c)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Max and sum over the 4 lanes of a row group (every lane gets the same bits).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr int fwd_tc_smem() {
  return (2 * ROWS + 4 * CHUNK) * (D + ROW_PAD) * 2 + (2 * L_MAX + L_MAX / CHUNK) * 4;
}

// Persistent: block i runs the items i, i + gridDim.x, ... (an item is one
// sequence, head and block of 128 queries) as a stream of units, one key
// chunk each; the next unit's loads (its chunk, and at an item's first chunk
// its queries and mask) fly while this unit is computed.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
mha_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ mask, bf16* __restrict__ o,
                  float* __restrict__ row_max, float* __restrict__ row_sum, int B, int L, int H,
                  float scale) {
  constexpr int S = D + ROW_PAD, NT = CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // [2][ROWS][S], by item parity
  bf16* ks = qs + 2 * ROWS * S;                          // [2][CHUNK][S], by unit parity
  bf16* vs = ks + 2 * CHUNK * S;                         // [2][CHUNK][S], by unit parity
  int* ms = reinterpret_cast<int*>(vs + 2 * CHUNK * S);  // [2][L_MAX] key mask, by item parity
  int* chunk_live = ms + 2 * L_MAX;                      // [L / CHUNK]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tiles = L / ROWS, n_chunks = L / CHUNK, n_items = B * H * tiles;
  const long hd = static_cast<long>(H) * D;
  // an item's (sequence, head) rows start at base(item); its queries at
  // row (item % tiles) * ROWS of them
  auto base = [&](int item) {
    return static_cast<long>(item / (H * tiles)) * L * hd + (item / tiles) % H * D;
  };
  auto issue = [&](int item, int c, int n, int u) {
    const long at = base(item);
    if (c == 0) {
      cp_rows<D>(qs + (n & 1) * ROWS * S, q + at + (item % tiles) * ROWS * hd, hd, ROWS);
      const int* mrow = mask + static_cast<long>(item / (H * tiles)) * L;
      for (int i = threadIdx.x; i < L / 4; i += blockDim.x)
        cp_async16(ms + (n & 1) * L_MAX + 4 * i, mrow + 4 * i);
    }
    cp_rows<D>(ks + (u & 1) * CHUNK * S, k + at + c * CHUNK * hd, hd, CHUNK);
    cp_rows<D>(vs + (u & 1) * CHUNK * S, v + at + c * CHUNK * hd, hd, CHUNK);
    cp_commit();
  };

  uint32_t qa[D / 16][4];
  float acc[D / 8][4], m[2], l[2];
  bool none = false;
  int item = blockIdx.x, c = 0, n = 0, u = 0;  // item, its chunk, items and units done
  if (item < n_items) issue(item, 0, 0, 0);
  while (item < n_items) {
    cp_wait<0>();
    __syncthreads();  // unit u has landed, and every warp is done with unit u - 1
    const int* live = ms + (n & 1) * L_MAX;
    if (c == 0) {
      for (int j = warp; j < n_chunks; j += TC_THREADS / 32) {
        const int any = __any_sync(0xffffffffu, (live[j * CHUNK + lane] > 0) |
                                                    (live[j * CHUNK + 32 + lane] > 0));
        if (lane == 0) chunk_live[j] = any;
      }
      __syncthreads();
      none = true;
      for (int j = 0; j < n_chunks; ++j) none = none && !chunk_live[j];
      load_a<D>(qa, qs + (n & 1) * ROWS * S, 16 * warp);
      zero<D>(acc);
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    // The next unit: this item's next chunk with a live key (every chunk of a
    // fully masked sequence), else the next item's chunk 0. Chunk 0 always
    // runs: a chunk of masked keys before a live one is exact too (the live
    // chunk's rescale by exp(-1e30 - m) = 0 removes it).
    int cn = c + 1;
    while (cn < n_chunks && !none && !chunk_live[cn]) ++cn;
    const bool last = cn >= n_chunks;
    const int item_n = last ? item + static_cast<int>(gridDim.x) : item;
    if (item_n < n_items) issue(item_n, last ? 0 : cn, n + last, u + 1);

    float s[NT][4], cmax[2] = {-INFINITY, -INFINITY}, alpha[2];
    mma_abt<D, NT>(s, qa, ks + (u & 1) * CHUNK * S, 0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = live[c * CHUNK + 8 * j + 2 * t + (e & 1)] > 0 ? s[j][e] * scale : MASKED;
        s[j][e] = x;
        cmax[e / 2] = fmaxf(cmax[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(cmax[r]));
      alpha[r] = expf(m[r] - m_new);  // 0 on an item's first chunk (m = -inf)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];
    uint32_t pa[NT / 2][4];
    to_a<NT>(pa, s);
    mma_at<D, NT / 2>(acc, pa, vs + (u & 1) * CHUNK * S, 0);

    if (last) {
      const int row = (item % tiles) * ROWS + 16 * warp;
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
      store_acc<D / 8>(o + base(item) + row * hd, hd, acc, 1.f / l[0], 1.f / l[1]);
      if (t == 0) {
        const long stat = static_cast<long>(item / tiles) * L + row + g;  // (b H + h) L + row
        row_max[stat] = m[0];
        row_sum[stat] = l[0];
        row_max[stat + 8] = m[1];
        row_sum[stat + 8] = l[1];
      }
    }
    item = item_n;
    c = last ? 0 : cn;
    n += last;
    ++u;
  }
}

constexpr int BWD_THREADS = 512;  // 16 warps: two for every 16 rows

template <int D>
constexpr int bwd_tc_smem() {
  return 2 * (4 * ROWS * (D + ROW_PAD) * 2 + 3 * ROWS * 4) + 2 * ROWS * P_STRIDE * 2 +
         BWD_THREADS / 32 * 16 * 4;
}

// The backward at L = ROWS, one launch, persistent: block i runs the items
// (sequence, head) i, i + gridDim.x, ...; the next item's rows, mask and
// row statistics load while this one is computed. Warps 2p and 2p + 1 share
// the 16 rows 16p .. 16p + 15: first as queries, each against one half of
// the keys (S and dP are 64 registers a thread, not 128, so 16 warps fit an
// SM), then as keys, each for one half of the head's columns.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
mha_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ mask,
                  const bf16* __restrict__ dout, const float* __restrict__ row_max,
                  const float* __restrict__ row_sum, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, float scale) {
  constexpr int S = D + ROW_PAD, L = ROWS, HALF = L / 2, NT = HALF / 8, IN = 4 * L * S;
  constexpr int DH = D / 2;  // head columns a warp owns in dq, dk and dv
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* in = reinterpret_cast<bf16*>(smem);  // [2][4][L][S]: Q, K, V, dO, by item parity
  bf16* ps = in + 2 * IN;                    // [L][P_STRIDE] each: P and dS, queries x keys
  bf16* dss = ps + L * P_STRIDE;
  int* st = reinterpret_cast<int*>(dss + L * P_STRIDE);  // [2][3][L]: mask, row max, row sum
  float* part = reinterpret_cast<float*>(st + 2 * 3 * L);  // [warps][16]: rowsum(dP P), by half
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pair = warp / 2, half = warp % 2, r0 = 16 * pair, n_items = B * H;
  const int key0 = HALF * half, col0 = DH * half;
  const long hd = static_cast<long>(H) * D;
  // item = b H + h: rows from (b L) hd + h D, statistics from item L
  auto base = [&](int item) { return static_cast<long>(item / H) * L * hd + (item % H) * D; };
  auto issue = [&](int item, int n) {
    const long at = base(item);
    bf16* dst = in + (n & 1) * IN;
    cp_rows<D>(dst, q + at, hd, L);
    cp_rows<D>(dst + L * S, k + at, hd, L);
    cp_rows<D>(dst + 2 * L * S, v + at, hd, L);
    cp_rows<D>(dst + 3 * L * S, dout + at, hd, L);
    int* sd = st + (n & 1) * 3 * L;
    const long seq = static_cast<long>(item / H) * L, stat = static_cast<long>(item) * L;
    for (int i = threadIdx.x; i < 3 * L / 4; i += blockDim.x) {
      const int what = i / (L / 4), j = 4 * (i % (L / 4));
      const void* src = what == 0   ? static_cast<const void*>(mask + seq + j)
                        : what == 1 ? static_cast<const void*>(row_max + stat + j)
                                    : static_cast<const void*>(row_sum + stat + j);
      cp_async16(sd + what * L + j, src);
    }
    cp_commit();
  };

  if (static_cast<int>(blockIdx.x) < n_items) issue(blockIdx.x, 0);
  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
    cp_wait<0>();
    __syncthreads();  // this item has landed, and every warp is done with the last one
    if (item + static_cast<int>(gridDim.x) < n_items) issue(item + gridDim.x, n + 1);
    const bf16* qs = in + (n & 1) * IN;
    const bf16* ks = qs + L * S;
    const bf16* vs = ks + L * S;
    const bf16* dos = vs + L * S;
    const int* live = st + (n & 1) * 3 * L;
    const float* sm = reinterpret_cast<const float*>(live + L);
    const float* sl = sm + L;
    const long at = base(item);

    // queries r0 .. r0 + 15 against keys key0 .. key0 + 63
    const float m[2] = {sm[r0 + g], sm[r0 + g + 8]};
    const float il[2] = {1.f / sl[r0 + g], 1.f / sl[r0 + g + 8]};
    float s[NT][4], dp[NT][4], delta[2] = {0.f, 0.f};
    {
      uint32_t a[D / 16][4];
      load_a<D>(a, qs, r0);
      mma_abt<D, NT>(s, a, ks, key0);
      load_a<D>(a, dos, r0);
      mma_abt<D, NT>(dp, a, vs, key0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = live[key0 + 8 * j + 2 * t + (e & 1)] > 0 ? s[j][e] * scale : MASKED;
        s[j][e] = expf(x - m[e / 2]) * il[e / 2];
        delta[e / 2] += s[j][e] * dp[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
    if (t == 0) {
      part[16 * warp + g] = delta[0];
      part[16 * warp + g + 8] = delta[1];
    }
    pair_sync(pair);
    // rowsum(dP P): the first half of the keys, then the second
#pragma unroll
    for (int r = 0; r < 2; ++r)
      delta[r] = part[32 * pair + g + 8 * r] + part[32 * pair + 16 + g + 8 * r];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - delta[e / 2]);
    store_acc<NT>(ps + r0 * P_STRIDE + key0, P_STRIDE, s, 1.f, 1.f);
    store_acc<NT>(dss + r0 * P_STRIDE + key0, P_STRIDE, dp, 1.f, 1.f);
    pair_sync(pair);  // both halves of these rows of dS are in shared memory
    {
      float acc[DH / 8][4];
      zero<DH>(acc);
      mma_smem<L / 16, DH, false>(acc, dss, P_STRIDE, r0, ks, S, col0);
      store_acc<DH / 8>(dq + at + r0 * hd + col0, hd, acc, scale, scale);
    }
    __syncthreads();

    // keys r0 .. r0 + 15 against every query, columns col0 .. col0 + DH - 1
    float acc[DH / 8][4];
    zero<DH>(acc);
    mma_smem<L / 16, DH, true>(acc, ps, P_STRIDE, r0, dos, S, col0);
    store_acc<DH / 8>(dv + at + r0 * hd + col0, hd, acc, 1.f, 1.f);
    zero<DH>(acc);
    mma_smem<L / 16, DH, true>(acc, dss, P_STRIDE, r0, qs, S, col0);
    store_acc<DH / 8>(dk + at + r0 * hd + col0, hd, acc, scale, scale);
  }
}

template <int D>
constexpr int split_tc_smem() {
  return (2 * ROWS + 2 * CHUNK) * (D + ROW_PAD) * 2 + L_MAX * 4;
}

// The backward at L > ROWS, first launch: dq and delta for 128 queries,
// two sweeps over the keys (delta, then dS and dq).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
mha_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ mask,
                     const bf16* __restrict__ dout, const float* __restrict__ row_max,
                     const float* __restrict__ row_sum, bf16* __restrict__ dq,
                     float* __restrict__ delta, int L, int H, float scale) {
  constexpr int S = D + ROW_PAD, NT = CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [ROWS][S]
  bf16* dos = qs + ROWS * S;                 // [ROWS][S]
  bf16* ks = dos + ROWS * S;                 // [CHUNK][S]
  bf16* vs = ks + CHUNK * S;                 // [CHUNK][S]
  int* live = reinterpret_cast<int*>(vs + CHUNK * S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tiles = L / ROWS, b = blockIdx.x / tiles, h = blockIdx.y;
  const int q0 = (blockIdx.x % tiles) * ROWS, r0 = 16 * warp;
  const long hd = static_cast<long>(H) * D, seq = static_cast<long>(b) * L;
  const long head = seq * hd + h * D;

  cp_rows<D>(qs, q + head + q0 * hd, hd, ROWS);
  cp_rows<D>(dos, dout + head + q0 * hd, hd, ROWS);
  for (int j = threadIdx.x; j < L; j += blockDim.x) live[j] = mask[seq + j] > 0;
  const long stat = (static_cast<long>(b) * H + h) * L + q0 + r0 + g;
  const float m[2] = {row_max[stat], row_max[stat + 8]};
  const float il[2] = {1.f / row_sum[stat], 1.f / row_sum[stat + 8]};

  uint32_t qa[D / 16][4], da[D / 16][4];
  float acc[D / 8][4], dl[2] = {0.f, 0.f};
  zero<D>(acc);
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < L / CHUNK; ++c) {
      cp_rows<D>(ks, k + head + c * CHUNK * hd, hd, CHUNK);
      cp_rows<D>(vs, v + head + c * CHUNK * hd, hd, CHUNK);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (pass == 0 && c == 0) {
        load_a<D>(qa, qs, r0);
        load_a<D>(da, dos, r0);
      }
      float s[NT][4], dp[NT][4];
      mma_abt<D, NT>(s, qa, ks, 0);
      mma_abt<D, NT>(dp, da, vs, 0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = live[c * CHUNK + 8 * j + 2 * t + (e & 1)] ? s[j][e] * scale : MASKED;
          const float p = expf(x - m[e / 2]) * il[e / 2];
          if (pass == 0)
            dl[e / 2] += p * dp[j][e];
          else
            dp[j][e] = p * (dp[j][e] - dl[e / 2]);
        }
      if (pass == 1) {
        uint32_t a[NT / 2][4];
        to_a<NT>(a, dp);
        mma_at<D, NT / 2>(acc, a, ks, 0);
      }
      __syncthreads();  // the chunk is consumed before the next one loads
    }
    if (pass == 0) {
      dl[0] = quad_sum(dl[0]);
      dl[1] = quad_sum(dl[1]);
    }
  }
  store_acc<D / 8>(dq + head + (q0 + r0) * hd, hd, acc, scale, scale);
  if (t == 0) {
    delta[stat] = dl[0];
    delta[stat + 8] = dl[1];
  }
}

template <int D>
constexpr int dkdv_tc_smem() {
  return (2 * ROWS + 2 * CHUNK) * (D + ROW_PAD) * 2 + 3 * CHUNK * 4;
}

// The backward at L > ROWS, second launch: dk and dv for 128 keys, one
// sweep over the queries: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
// are accumulator fragments that feed dv = P^T dO and dk = dS^T Q directly.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
mha_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ row_max,
                       const float* __restrict__ row_sum, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, float scale) {
  constexpr int S = D + ROW_PAD, NT = CHUNK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [ROWS][S]
  bf16* vs = ks + ROWS * S;                  // [ROWS][S]
  bf16* qs = vs + ROWS * S;                  // [CHUNK][S]
  bf16* dos = qs + CHUNK * S;                // [CHUNK][S]
  float* sm = reinterpret_cast<float*>(dos + CHUNK * S);  // row max, 1 / row sum, delta
  float* sl = sm + CHUNK;
  float* sd = sl + CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tiles = L / ROWS, b = blockIdx.x / tiles, h = blockIdx.y;
  const int k0 = (blockIdx.x % tiles) * ROWS, r0 = 16 * warp;
  const long hd = static_cast<long>(H) * D, seq = static_cast<long>(b) * L;
  const long head = seq * hd + h * D;
  const long stat0 = (static_cast<long>(b) * H + h) * L;

  cp_rows<D>(ks, k + head + k0 * hd, hd, ROWS);
  cp_rows<D>(vs, v + head + k0 * hd, hd, ROWS);
  const bool live[2] = {mask[seq + k0 + r0 + g] > 0, mask[seq + k0 + r0 + g + 8] > 0};

  uint32_t ka[D / 16][4], va[D / 16][4];
  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);
  for (int c = 0; c < L / CHUNK; ++c) {
    cp_rows<D>(qs, q + head + c * CHUNK * hd, hd, CHUNK);
    cp_rows<D>(dos, dout + head + c * CHUNK * hd, hd, CHUNK);
    cp_commit();
    if (threadIdx.x < CHUNK) {
      const long i = stat0 + c * CHUNK + threadIdx.x;
      sm[threadIdx.x] = row_max[i];
      sl[threadIdx.x] = 1.f / row_sum[i];
      sd[threadIdx.x] = delta[i];
    }
    cp_wait<0>();
    __syncthreads();
    if (c == 0) {
      load_a<D>(ka, ks, r0);
      load_a<D>(va, vs, r0);
    }
    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, ka, qs, 0);
    mma_abt<D, NT>(dp, va, dos, 0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * t + (e & 1);
        const float x = live[e / 2] ? s[j][e] * scale : MASKED;
        s[j][e] = expf(x - sm[i]) * sl[i];
        dp[j][e] = s[j][e] * (dp[j][e] - sd[i]);
      }
    uint32_t a[NT / 2][4];
    to_a<NT>(a, s);
    mma_at<D, NT / 2>(dva, a, dos, 0);
    to_a<NT>(a, dp);
    mma_at<D, NT / 2>(dka, a, qs, 0);
    __syncthreads();  // the chunk is consumed before the next one loads
  }
  store_acc<D / 8>(dk + head + (k0 + r0) * hd, hd, dka, scale, scale);
  store_acc<D / 8>(dv + head + (k0 + r0) * hd, hd, dva, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Blocks of a persistent kernel: as many as fit on the card at once, at
// most one per item.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, int n_items, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  *grid = n_items < sms * per_sm ? n_items : sms * per_sm;
  return err;
}

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* row_max, void* row_sum, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  constexpr int smem = fwd_tc_smem<D>();
  int grid = 0;
  cudaError_t err =
      persistent_grid(mha_fwd_tc_kernel<D>, TC_THREADS, smem, B * H * (L / ROWS), &grid);
  if (err != cudaSuccess) return err;
  mha_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(mask), static_cast<bf16*>(o), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), B, L, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_tc(const void* q, const void* k, const void* v, const void* mask,
                   const void* dout, const void* row_max, const void* row_sum, void* dq,
                   void* dk, void* dv, void* delta, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *do_ = static_cast<const bf16*>(dout);
  const int* mask_ = static_cast<const int*>(mask);
  const float *m_ = static_cast<const float*>(row_max), *l_ = static_cast<const float*>(row_sum);
  cudaError_t err;
  if (L == ROWS) {
    constexpr int smem = bwd_tc_smem<D>();
    int grid = 0;
    err = persistent_grid(mha_bwd_tc_kernel<D>, BWD_THREADS, smem, B * H, &grid);
    if (err != cudaSuccess) return err;
    mha_bwd_tc_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
        q_, k_, v_, mask_, do_, m_, l_, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), B, H, scale);
    return cudaGetLastError();
  }
  const dim3 grid(B * (L / ROWS), H);
  constexpr int smem_dq = split_tc_smem<D>(), smem_dkdv = dkdv_tc_smem<D>();
  if ((err = set_smem(mha_bwd_dq_tc_kernel<D>, smem_dq)) != cudaSuccess) return err;
  mha_bwd_dq_tc_kernel<D><<<grid, TC_THREADS, smem_dq, stream>>>(
      q_, k_, v_, mask_, do_, m_, l_, static_cast<bf16*>(dq), static_cast<float*>(delta), L, H,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(mha_bwd_dkdv_tc_kernel<D>, smem_dkdv)) != cudaSuccess) return err;
  mha_bwd_dkdv_tc_kernel<D><<<grid, TC_THREADS, smem_dkdv, stream>>>(
      q_, k_, v_, mask_, do_, m_, l_, static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, H, scale);
  return cudaGetLastError();
}

// ---- f32 rows: launches of the CUDA-core kernels ---------------------------
template <int D, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                void* row_max, void* row_sum, int B, int L, int H, float scale,
                cudaStream_t stream) {
  const dim3 grid(B * (L / ROWS), H);
  mha_fwd_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), L, H, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                const void* row_max, const void* row_sum, void* dq, void* dk, void* dv,
                void* delta, int B, int L, int H, float scale, cudaStream_t stream) {
  const dim3 grid(B * (L / ROWS), H);
  mha_bwd_dq_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      static_cast<T*>(dq), static_cast<float*>(delta), L, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

bool shape_ok(int elem, int d, int B, int L, int H) {
  return (elem == F32 || elem == BF16) && (d == 16 || d == 32 || d == 64) && B > 0 && H > 0 &&
         H <= 65535 && L > 0 && L % ROWS == 0 && L <= L_MAX &&
         static_cast<long>(B) * (L / ROWS) * H <= 0x7fffffffL;
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: o (B, L, H*d) in the rows' type, row_max and row_sum
// (B, H, L) f32; bf16 rows on the tensor cores, f32 rows on the CUDA cores.
// Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a type, d or L the kernel does not take.
int cvdb_mha_fwd(int elem, int d, const void* q, const void* k, const void* v, const void* mask,
                 void* o, void* row_max, void* row_sum, int B, int L, int H, float scale,
                 int device, void* stream) {
  if (!shape_ok(elem, d, B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVDB_FWD(DD, T) fwd<DD, T>(q, k, v, mask, o, row_max, row_sum, B, L, H, scale, s)
  if (elem == F32)
    err = d == 16 ? CVDB_FWD(16, float) : d == 32 ? CVDB_FWD(32, float) : CVDB_FWD(64, float);
  else
    err = d == 16   ? fwd_tc<16>(q, k, v, mask, o, row_max, row_sum, B, L, H, scale, s)
          : d == 32 ? fwd_tc<32>(q, k, v, mask, o, row_max, row_sum, B, L, H, scale, s)
                    : fwd_tc<64>(q, k, v, mask, o, row_max, row_sum, B, L, H, scale, s);
#undef CVDB_FWD
  return static_cast<int>(err);
}

// Backward on `stream` from the forward's row_max and row_sum: dq, dk, dv
// (B, L, H*d) in the rows' type; delta (B, H, L) f32 is scratch (the
// per-query rowsum(dp * p)). bf16 rows at L 128: one launch; otherwise two,
// dq then dk/dv. Returns the first non-zero cudaGetLastError().
int cvdb_mha_bwd(int elem, int d, const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* row_max, const void* row_sum, void* dq, void* dk,
                 void* dv, void* delta, int B, int L, int H, float scale, int device,
                 void* stream) {
  if (!shape_ok(elem, d, B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVDB_BWD(F) F(q, k, v, mask, dout, row_max, row_sum, dq, dk, dv, delta, B, L, H, scale, s)
  if (elem == F32)
    err = d == 16   ? CVDB_BWD((bwd<16, float>))
          : d == 32 ? CVDB_BWD((bwd<32, float>))
                    : CVDB_BWD((bwd<64, float>));
  else
    err = d == 16 ? CVDB_BWD(bwd_tc<16>) : d == 32 ? CVDB_BWD(bwd_tc<32>) : CVDB_BWD(bwd_tc<64>);
#undef CVDB_BWD
  return static_cast<int>(err);
}

}  // extern "C"
