// Paged decode attention for Hopper (sm_90a): one query token per slot
// attends over K/V reached through the slot's block table.
//
// Replaces two Pallas kernels of the reference package:
//   repro/kernels/paged_attention.py       : _paged_decode_kernel
//     (wrapper _paged_attention_pallas), the model-dtype pool;
//   repro/kernels/paged_attention_quant.py : _paged_quant_decode_kernel
//     (wrapper _paged_attention_quant_pallas), int8 code pools with one
//     float32 scale per (position, kv-head).
// One template serves both: QUANT folds k_scale into the scores after the
// QK dot and v_scale into the softmax weights before the PV dot, in the
// reference's order, so no dequantized tile is ever formed.
//
// Shapes: q (B, H, D); pools (N, bs, KV, D); scale pools (N, bs, KV);
// block_tables (B, nb) int32; lengths (B,) int32, the position of each
// slot's newest token (its K/V already written), so columns > lengths[b]
// are masked. H = KV * rep; query head h*rep + r belongs to kv-head h.
//
// Bound: bytes. A slot reads the K/V rows of its lengths[b] + 1 positions
// once (plus their scales), does 4*rep*D flops per row, far below the
// tensor-core crossover, so the least time is bytes / 3.35 TB/s.
//
// Design, simple and correct first:
// * one block of 128 threads per (slot, kv-head); the rep query heads of the
//   kv-head share every K/V row the block loads;
// * the block reads its block-table row itself and loops over the slot's
//   blocks in logical order, skipping blocks wholly past lengths[b] (their
//   softmax weights would be exactly 0);
// * each block of the pool is taken in tiles of up to KT positions staged in
//   shared memory as float32 (K rows padded by one float against bank
//   conflicts); scores, the running max and sum, and the accumulator are
//   float32; the output is rounded once to q's type;
// * masked columns become the finite NEG_INF = -2^30 by a select, so
//   exp(NEG_INF - m) is exactly 0 and poisoned or trash rows cannot leak.
// Not done yet (a later PR): splitting the block axis over several blocks
// with a log-sum-exp merge (flash-decoding) to fill more than B*KV SMs,
// vectorised loads, tensor cores for the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;   // -2^30, finite
constexpr int THREADS = 128;
constexpr int KT = 16;                      // positions per staged tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename QT, typename KT_, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KT_* __restrict__ kpool,
                    const KT_* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int nb, int bs, int kvh, int rep, int d, float scale) {
  extern __shared__ float sm[];
  const int kt = bs < KT ? bs : KT;
  float* qs = sm;                         // rep * d
  float* acc = qs + rep * d;              // rep * d
  float* ks = acc + rep * d;              // kt * (d + 1)
  float* vs = ks + kt * (d + 1);          // kt * d
  float* sc = vs + kt * d;                // rep * kt: scores, then p
  float* mrow = sc + rep * kt;            // rep
  float* lrow = mrow + rep;               // rep
  float* alpha = lrow + rep;              // rep
  float* ksc = alpha + rep;               // kt
  float* vsc = ksc + kt;                  // kt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  int nblk = len / bs + 1;                // blocks holding a column <= len
  if (nblk > nb) nblk = nb;
  const long long qbase = ((long long)b * kvh * rep + (long long)h * rep) * d;

  for (int i = tid; i < rep * d; i += THREADS) {
    qs[i] = to_f(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const long long phys = block_tables[(long long)b * nb + j];
    for (int t0 = 0; t0 < bs; t0 += kt) {
      const int n = (bs - t0) < kt ? (bs - t0) : kt;
      const int col0 = j * bs + t0;
      if (col0 > len) break;              // the rest of the block is masked
      // stage this tile's K and V rows (and scales) as float32
      for (int e = tid; e < n * d; e += THREADS) {
        const int t = e / d, dd = e - t * d;
        const long long g = ((phys * bs + t0 + t) * kvh + h) * d + dd;
        ks[t * (d + 1) + dd] = to_f(kpool[g]);
        vs[t * d + dd] = to_f(vpool[g]);
      }
      if (QUANT) {
        for (int t = tid; t < n; t += THREADS) {
          const long long g = (phys * bs + t0 + t) * kvh + h;
          ksc[t] = kscale[g];
          vsc[t] = vscale[g];
        }
      }
      __syncthreads();
      // scores (rep, n): dot * scale (* k_scale), masked by select
      for (int e = tid; e < rep * n; e += THREADS) {
        const int r = e / n, t = e - r * n;
        const float* qr = qs + r * d;
        const float* kr = ks + t * (d + 1);
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd) dot += qr[dd] * kr[dd];
        float s = dot * scale;
        if (QUANT) s = s * ksc[t];
        sc[r * kt + t] = (col0 + t <= len) ? s : NEG_INF;
      }
      __syncthreads();
      // online softmax statistics, one thread per query head
      for (int r = tid; r < rep; r += THREADS) {
        float mb = NEG_INF;
        for (int t = 0; t < n; ++t) mb = fmaxf(mb, sc[r * kt + t]);
        const float m_new = fmaxf(mrow[r], mb);
        const float a = expf(mrow[r] - m_new);
        float sum = 0.f;
        for (int t = 0; t < n; ++t) {
          const float p = expf(sc[r * kt + t] - m_new);
          sc[r * kt + t] = p;
          sum += p;
        }
        lrow[r] = a * lrow[r] + sum;
        mrow[r] = m_new;
        alpha[r] = a;
      }
      __syncthreads();
      // acc = acc * alpha + p (* v_scale) @ V
      for (int e = tid; e < rep * d; e += THREADS) {
        const int r = e / d, dd = e - r * d;
        float s = 0.f;
        for (int t = 0; t < n; ++t) {
          float p = sc[r * kt + t];
          if (QUANT) p = p * vsc[t];
          s += p * vs[t * d + dd];
        }
        acc[e] = acc[e] * alpha[r] + s;
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < rep * d; e += THREADS) {
    from_f(out + qbase + e, acc[e] / lrow[e / d]);
  }
}

template <typename QT, typename KT_, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* bt, const int* ln, void* out, int b,
           int kvh, int rep, int d, int nb, int bs, float scale,
           cudaStream_t stream) {
  const int kt = bs < KT ? bs : KT;
  const size_t smem = sizeof(float) *
      (size_t)(2 * rep * d + kt * (d + 1) + kt * d + rep * kt + 3 * rep +
               2 * kt);
  auto kern = paged_decode_kernel<QT, KT_, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kvh, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT_*>(kp),
      static_cast<const KT_*>(vp), ksc, vsc, bt, ln, static_cast<QT*>(out),
      nb, bs, kvh, rep, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Model-dtype pool; q and the pools share one type: float32 (bf16 = 0) or
// bfloat16 (bf16 = 1). Returns the CUDA error code of the launch (0: ok).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const int* block_tables,
                           const int* lengths, void* out, int b, int kvh,
                           int rep, int d, int nb, int bs, float scale,
                           int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, block_tables, lengths, out, b,
        kvh, rep, d, nb, bs, scale, s);
  return launch<float, float, false>(q, k_pool, v_pool, nullptr, nullptr,
                                     block_tables, lengths, out, b, kvh, rep,
                                     d, nb, bs, scale, s);
}

// int8 code pools with float32 scale pools; q (and the output) float32
// (bf16 = 0) or bfloat16 (bf16 = 1).
int paged_attention_quant_launch(const void* q, const void* k_pool,
                                 const void* v_pool, const float* k_scale,
                                 const float* v_scale,
                                 const int* block_tables, const int* lengths,
                                 void* out, int b, int kvh, int rep, int d,
                                 int nb, int bs, float scale, int bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, b,
        kvh, rep, d, nb, bs, scale, s);
  return launch<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths, out, b, kvh, rep,
                                     d, nb, bs, scale, s);
}

}  // extern "C"
