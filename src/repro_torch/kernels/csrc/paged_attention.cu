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
// reference's order (codes dot -> k-scale -> mask -> softmax -> v-scale ->
// codes dot -> divide by the sum), so no dequantized tile is ever formed.
//
// Shapes: q (B, H, D); pools (N, bs, KV, D); scale pools (N, bs, KV);
// block_tables (B, nb) int32; lengths (B,) int32, the position of each
// slot's newest token (its K/V already written), so columns > lengths[b]
// are masked. H = KV * rep; query head h*rep + r belongs to kv-head h.
// D is a multiple of 8 up to 256; any rep >= 1.
//
// Bound: bytes. A slot reads the K/V rows of its lengths[b] + 1 positions
// once (plus their scales) and does 4*rep*D flops per row; with rep <= 8
// that is far below the tensor-core crossover, so the least time is
// bytes / 3.35 TB/s, and the design is about keeping enough bytes in
// flight on every SM.
//
// Design (split-KV, "flash-decoding"):
// * Grid (kv-head x head group, slot, split). Split s of slot b takes the P
//   pool blocks [s*P, s*P + P) of the slot's table. The number of splits
//   and P come from static shapes only (the wrapper's split_plan: nb, bs,
//   B*KV, the SM count and the instance's CTAs per SM, which
//   paged_attention_ctas_per_sm asks of the card; one wave of resident
//   CTAs, at least 32 positions per split), never from lengths' values, so
//   the launch is the same every step and can be captured in a CUDA graph.
//   Past one wave, a late CTA of a slow split costs a whole CTA time; below
//   it, SMs idle. A CTA reads its block ids and query heads while
//   lengths[b] is on its way; one whose range lies wholly past lengths[b]
//   reads nothing more and writes the neutral partial (m = NEG_INF, l = 0,
//   acc = 0).
// * Inside a CTA the 128 threads form NG = 128 / LPR lane groups, LPR lanes
//   per K/V row (a power of two, at most 32). Rows are read as 16-byte
//   vectors (8 bf16, 4 float32 or 16 int8 codes; 8-byte vectors of 8 codes
//   when an int8 row is not a multiple of 16 codes), neighbouring lanes on
//   neighbouring addresses, widened in registers; no float32 copy is
//   staged. Group g takes positions start + k*NG + g, U of them per step.
//   The vectors travel by cp.async into a ring of NSTAGE steps in shared
//   memory, NSTAGE - 1 steps in flight while one is computed. A bf16 or
//   float32 lane reads back only its own slots, so its own cp.async groups
//   order the ring with no barrier. An int8 lane computes on 8 codes (half
//   a 16-byte vector another lane of its group copied), so its query heads
//   and accumulators take the registers of a bf16 lane (16 codes a lane
//   took ~200 registers and half the CTAs per SM); two __syncwarp per step
//   order the group's ring, and one copy of each scale serves the group.
//   Codes widen exactly by a byte permute into 2^23's mantissa and one
//   subtraction (I2F runs at a quarter of the FMA rate). Masked positions
//   are zero-filled without a read, so poisoned tails are never touched.
//   (A register prefetch was tried first: copying the prefetched registers
//   at the end of a step waited for the loads, one step in flight, 0.2 of
//   the bytes bound.)
// * Scores: each lane dots its E*C elements with the rep query heads of
//   the kv-head (held in registers as float32). When the group has a lane
//   for each of the step's rep*U (head, position) values, a transposed
//   shuffle reduction (reduce-scatter) leaves each lane with ONE full dot
//   product, that lane computes that one softmax weight and its head's
//   rescale, and shuffles hand every lane the weights it needs (16 lanes,
//   rep 4: 20 shuffles a step instead of 32, and no lane repeats another's
//   exponentials). Otherwise (small D) an xor-shuffle completes every dot
//   product on every lane and every lane updates every head. Running max,
//   sum and accumulator are float32, the scores in log2 units (scale *
//   log2 e folded into the scale) so each exponential is one exp2f.
// * A CTA combines its NG groups in ascending order through shared memory
//   (reusing the drained ring) into one partial (acc[rep, D], m[rep],
//   l[rep], unnormalised) per (slot, head, split). A second small launch,
//   a programmatic dependent of the first (its CTAs are launched while
//   the split pass drains and wait for its end), merges the splits of each
//   (slot, head) by log-sum-exp in ascending split order and rounds once to
//   q's dtype. With a single split the CTA writes the output itself. There
//   are no atomics: the output bits are the same run to run.
// * Masked columns become the finite NEG_INF = -2^30 by a select, never an
//   add; split 0 always holds column 0, so every merged max is finite and
//   exp2(NEG_INF - M) is exactly 0: empty splits, idle groups and masked
//   columns contribute exact zeros.
// * Head groups: the rep query heads of a kv-head share every K/V row the
//   CTA loads. Query heads and accumulators cost 8 registers per head each
//   per lane, so a CTA takes at most RG = 8 heads; a larger rep is cut into
//   ceil(rep / 8) head groups that each read the rows.
// Not done: tensor cores (not needed below rep ~ 32), TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;   // -2^30, finite
constexpr int THREADS = 128;
constexpr int U = 2;                        // positions per group per step
constexpr int NSTAGE = 4;                   // cp.async ring: 3 steps in flight

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One lane's vector of E pool elements: the raw load and its widening.
template <typename KT_, int E> struct PoolVec;

template <> struct PoolVec<__nv_bfloat16, 8> {
  using R = uint4;
  __device__ static __forceinline__ void widen(const R& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // bf16 -> f32 is exact: a shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct PoolVec<float, 4> {
  using R = uint4;
  __device__ static __forceinline__ void widen(const R& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

// Four int8 codes to float32, exactly, without I2F (a quarter-rate
// conversion): the biased byte b + 128 becomes the low mantissa byte of
// 2^23 (0x4B0000xx), and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void widen_codes(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
           8388736.0f;
}

template <> struct PoolVec<int8_t, 8> {
  using R = uint2;
  __device__ static __forceinline__ void widen(const R& r, float* f) {
    widen_codes(r.x, f);
    widen_codes(r.y, f + 4);
  }
};

constexpr unsigned FULL = 0xffffffffu;

// Sum each of the N values over a group of 2x lanes (x, x/2, ..., 1 the
// xor offsets; 2x >= N), transposed: at each level a lane keeps half of its
// values and sends the other half to its partner, so the lane ends with
// the group's full sum of ONE value, j = lane_in_group / (2x / N), at
// N - 1 + log2(2x / N) shuffles instead of N * log2(2x).
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int li, int x) {
  if constexpr (N == 1) {
    float t = v[0];
    for (; x > 0; x >>= 1) t += __shfl_xor_sync(FULL, t, x);
    return t;
  } else {
    constexpr int H = N / 2;
    const bool hi = (li & x) != 0;
    float h[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = hi ? v[i] : v[i + H];
      const float keep = hi ? v[i + H] : v[i];
      h[i] = keep + __shfl_xor_sync(FULL, send, x);
    }
    return reduce_scatter<H>(h, li, x >> 1);
  }
}

// E query elements (16-byte aligned: D is a multiple of 8) as float32.
template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
#pragma unroll
  for (int v = 0; v < E / 8; ++v)
    PoolVec<__nv_bfloat16, 8>::widen(
        __ldg(reinterpret_cast<const uint4*>(p) + v), f + 8 * v);
}

template <int E>
__device__ __forceinline__ void load_row(const float* p, float* f) {
#pragma unroll
  for (int v = 0; v < E / 4; ++v)
    PoolVec<float, 4>::widen(__ldg(reinterpret_cast<const uint4*>(p) + v),
                             f + 4 * v);
}

// cp.async of one lane's vector (16 or 8 bytes) or of one scale (4 bytes)
// into shared memory; ok == false reads nothing and zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(sa), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(sa), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of the split kernel, in bytes: the cp.async ring (which the
// CTA's combine reuses for its ng * rg * d accumulators once the ring is
// drained), then the groups' m, l and merge weights, the heads' sums, and
// the split's block ids.
template <typename R, bool QUANT, int C>
__host__ __device__ __forceinline__ int ring_bytes(int ng, int rg, int d) {
  const int ring = 2 * NSTAGE * U * C * THREADS * (int)sizeof(R) +
                   (QUANT ? NSTAGE * U * THREADS * 2 * 4 : 0);
  const int accs = ng * rg * d * 4;
  return ring > accs ? ring : accs;
}

template <typename R, bool QUANT, int C>
__host__ __device__ __forceinline__ int smem_bytes(int ng, int rg, int d,
                                                   int P) {
  return ring_bytes<R, QUANT, C>(ng, rg, d) + 4 * (3 * ng * rg + rg) + 4 * P;
}

template <typename QT, typename KT_, bool QUANT, int E, int C, int RG,
          bool PAIR>
__global__ void __launch_bounds__(THREADS)
paged_decode_split(const QT* __restrict__ q, const KT_* __restrict__ kpool,
                   const KT_* __restrict__ vpool,
                   const float* __restrict__ kscale,
                   const float* __restrict__ vscale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, QT* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int nb, int bs, int bsl, int kvh, int rep, int d, int lpr,
                   int P, int nsplit, float scale2) {
  using PV = PoolVec<KT_, E>;
  using R = typename PV::R;
  extern __shared__ __align__(16) unsigned char smem[];
  // let the merge pass's CTAs launch early; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int ng = THREADS / lpr;             // lane groups
  const int ngroups = (rep + RG - 1) / RG;  // head groups per kv-head
  const int kv = blockIdx.x / ngroups;
  const int grp = blockIdx.x - kv * ngroups;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int nr = min(RG, rep - grp * RG);   // heads of this CTA
  const long long hb = (long long)b * kvh * rep + kv * rep + grp * RG;

  R* s_k = reinterpret_cast<R*>(smem);      // [NSTAGE][U][C][THREADS]
  R* s_v = s_k + NSTAGE * U * C * THREADS;
  float* s_sc = reinterpret_cast<float*>(s_v + NSTAGE * U * C * THREADS);
  float* s_acc = reinterpret_cast<float*>(smem);   // after the ring drains
  float* s_m = reinterpret_cast<float*>(
      smem + ring_bytes<R, QUANT, C>(ng, RG, d));  // ng * RG
  float* s_l = s_m + ng * RG;               // ng * RG
  float* s_w = s_l + ng * RG;               // ng * RG: merge weights
  float* s_L = s_w + ng * RG;               // RG
  int* s_blk = reinterpret_cast<int*>(s_L + RG);   // P

  // the split's block ids and the query heads are read while lengths[b]
  // is on its way
  const int sp = s * P;
  const int nbs = min(P, nb - sp);
  for (int j = tid; j < nbs; j += THREADS)
    s_blk[j] = block_tables[(long long)b * nb + sp + j];
  const int g = tid / lpr;
  const int li = tid - g * lpr;
  const int nch = d / E;
  float qf[RG][C][E], acc[RG][C][E], m[RG], l[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (r < nr && c * lpr + li < nch)
        load_row<E>(q + (hb + r) * d + (long long)(c * lpr + li) * E,
                    qf[r][c]);
      else
#pragma unroll
        for (int i = 0; i < E; ++i) qf[r][c][i] = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][c][i] = 0.f;
    }
  }
  const int len = lengths[b];
  const int start = sp * bs;
  if (s > 0 && start > len) {               // wholly past the length
    for (int e = tid; e < nr * d; e += THREADS) {
      const int r = e / d;
      part_acc[((hb + r) * nsplit + s) * d + (e - r * d)] = 0.f;
    }
    for (int r = tid; r < nr; r += THREADS) {
      part_ml[((hb + r) * nsplit + s) * 2] = NEG_INF;
      part_ml[((hb + r) * nsplit + s) * 2 + 1] = 0.f;
    }
    return;
  }
  const int end = min(start + nbs * bs, len + 1);   // exclusive
  __syncthreads();                          // s_blk

  const int stepw = U * ng;                 // positions per step
  const int nsteps = (end - start + stepw - 1) / stepw;
  // fast: at least one lane per (head, position) value of a step, so the
  // group's sums are reduce-scattered and each weight computed once
  constexpr int NV = RG * U;
  const bool fast = lpr >= NV;
  const int lw = fast ? lpr / NV : 1;       // lanes holding one value

  // step k: group g takes positions start + (k*U + u)*ng + g. Without
  // PAIR each lane copies its own vectors into its own ring slots, so only
  // its own cp.async groups order the ring: no barrier. With PAIR (int8
  // rows of a multiple of 16 codes) the group's lanes copy its U rows as
  // 16-byte pieces, one piece a lane, and each lane computes on an 8-code
  // half of a piece: a __syncwarp before a slot is refilled and after it
  // lands orders the group's ring.
  auto row_of = [&](int pos) -> long long {   // pool row of a position
    const int x = pos - start;
    const int j = bsl >= 0 ? x >> bsl : x / bs;
    return ((long long)s_blk[j] * bs + (x - j * bs)) * kvh + kv;
  };
  auto slot_of = [&](int st, int u, int c) -> int {
    if constexpr (PAIR) return ((st * ng + g) * U + u) * nch + li;
    else return ((st * U + u) * C + c) * THREADS + tid;
  };
  auto sc_slot = [&](int st, int u, int which) -> int {   // k: 0, v: 1
    if constexpr (PAIR) return ((st * ng + g) * U + u) * 2 + which;
    else return ((st * U + u) * 2 + which) * THREADS + tid;
  };
  // PAIR: this lane copies 16-byte piece pk of row pu (of U rows of nch / 2
  // pieces each), and if li < 2U the k (even li) or v scale of row li / 2
  const int pu = PAIR ? li / (nch >> 1) : 0;
  const int pk = PAIR ? li - pu * (nch >> 1) : 0;
  auto copy_in = [&](int k) {
    const int st = k % NSTAGE;
    if constexpr (PAIR) {
      if (pu < U) {
        const int pos = start + (k * U + pu) * ng + g;
        const bool ok = pos < end;
        const long long off = (ok ? row_of(pos) : 0) * d + 16LL * pk;
        const int slot = ((st * ng + g) * U + pu) * nch + 2 * pk;
        cp_async<16>(s_k + slot, ok ? kpool + off : kpool, ok);
        cp_async<16>(s_v + slot, ok ? vpool + off : vpool, ok);
      }
      if (li < 2 * U) {
        const int pos = start + (k * U + (li >> 1)) * ng + g;
        const bool ok = pos < end;
        const float* src = (li & 1) ? vscale : kscale;
        cp_async<4>(s_sc + sc_slot(st, li >> 1, li & 1),
                    ok ? src + row_of(pos) : src, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = start + (k * U + u) * ng + g;
        const bool ok = pos < end;
        const long long row = ok ? row_of(pos) : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool okc = ok && c * lpr + li < nch;
          const long long off = row * d + (long long)(c * lpr + li) * E;
          cp_async<sizeof(R)>(s_k + slot_of(st, u, c),
                              okc ? kpool + off : kpool, okc);
          cp_async<sizeof(R)>(s_v + slot_of(st, u, c),
                              okc ? vpool + off : vpool, okc);
        }
        if constexpr (QUANT) {
          cp_async<4>(s_sc + sc_slot(st, u, 0), ok ? kscale + row : kscale,
                      ok);
          cp_async<4>(s_sc + sc_slot(st, u, 1), ok ? vscale + row : vscale,
                      ok);
        }
      }
    }
  };

#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nsteps) copy_in(k);
    cp_async_commit();
  }
  for (int k = 0; k < nsteps; ++k) {
    if constexpr (PAIR) __syncwarp();       // slot (k - 1) % NSTAGE is read
    if (k + NSTAGE - 1 < nsteps) copy_in(k + NSTAGE - 1);   // in flight
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();            // step k has landed
    if constexpr (PAIR) __syncwarp();
    const int st = k % NSTAGE;
    // partial dots of this lane (a lane past the row's chunks holds a zero
    // query: its slot is zero-filled, or with PAIR holds finite int8 codes)
    float sc[RG][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[C][E];
#pragma unroll
      for (int c = 0; c < C; ++c)
        PV::widen(s_k[slot_of(st, u, c)], kf[c]);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < E; ++i) dot = fmaf(qf[r][c][i], kf[c][i], dot);
        sc[r][u] = dot;
      }
    }
    const int first = start + k * U * ng + g;    // this group's first column
    // scores in log2 units (scale2 = scale * log2 e), exp2 throughout;
    // p: softmax weights (v_scale folded in), a: each head's rescale
    float p[RG][U], a[RG];
    if (fast) {
      // reduce-scatter: this lane ends with the group's sum of value
      // j = r*U + u (j = li / lw), computes that one weight, and the group
      // then shares the weights by shuffles
      float flat[NV];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) flat[r * U + u] = sc[r][u];
      const float dot = reduce_scatter<NV>(flat, li, lpr >> 1);
      const int u = (li / lw) % U;
      const bool any = first < end;             // else the step is masked
      float sv = dot * scale2;
      if constexpr (QUANT) sv = sv * s_sc[sc_slot(st, u, 0)];
      sv = first + u * ng < end ? sv : NEG_INF;  // mask: select
      float mb = sv;
#pragma unroll
      for (int x = 1; x < U; x <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, x * lw));
      const float mn = any ? fmaxf(m[0], mb) : m[0];
      const float am = any ? exp2f(m[0] - mn) : 1.f;
      float pe = any ? exp2f(sv - mn) : 0.f;
      float sum = pe;
#pragma unroll
      for (int x = 1; x < U; x <<= 1) sum += __shfl_xor_sync(FULL, sum, x * lw);
      l[0] = am * l[0] + sum;
      m[0] = mn;
      if constexpr (QUANT) pe = pe * s_sc[sc_slot(st, u, 1)];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (r >= nr) continue;
        a[r] = __shfl_sync(FULL, am, r * U * lw, lpr);
#pragma unroll
        for (int u2 = 0; u2 < U; ++u2)
          p[r][u2] = __shfl_sync(FULL, pe, (r * U + u2) * lw, lpr);
      }
    } else {
      // every lane completes every dot product and runs every head's update
      for (int x = lpr >> 1; x > 0; x >>= 1) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (r < nr) sc[r][u] += __shfl_xor_sync(FULL, sc[r][u], x);
      }
      const bool any = first < end;
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (r >= nr) continue;
        float mb = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float sv = sc[r][u] * scale2;
          if constexpr (QUANT) sv = sv * s_sc[sc_slot(st, u, 0)];
          p[r][u] = first + u * ng < end ? sv : NEG_INF;   // mask: select
          mb = fmaxf(mb, p[r][u]);
        }
        const float mn = any ? fmaxf(m[r], mb) : m[r];
        a[r] = any ? exp2f(m[r] - mn) : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[r][u] = any ? exp2f(p[r][u] - mn) : 0.f;
          sum += p[r][u];
          if constexpr (QUANT) p[r][u] = p[r][u] * s_sc[sc_slot(st, u, 1)];
        }
        l[r] = a[r] * l[r] + sum;
        m[r] = mn;
      }
    }
    // acc = acc * a + p @ V, one widened V row live at a time
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][c][i] *= a[r];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[C][E];
#pragma unroll
      for (int c = 0; c < C; ++c)
        PV::widen(s_v[slot_of(st, u, c)], vf[c]);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (r >= nr) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < E; ++i)
            acc[r][c][i] = fmaf(p[r][u], vf[c][i], acc[r][c][i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring becomes s_acc

  // combine the NG groups of this CTA, in ascending group order
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (r >= nr) continue;
    if (fast ? li == r * U * lw : li == 0) {   // a lane holding head r's m, l
      s_m[g * RG + r] = fast ? m[0] : m[r];
      s_l[g * RG + r] = fast ? l[0] : l[r];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * lpr + li >= nch) continue;
      float* dst = s_acc + (g * RG + r) * d + (c * lpr + li) * E;
#pragma unroll
      for (int i = 0; i < E; i += 4)
        *reinterpret_cast<float4*>(dst + i) = make_float4(
            acc[r][c][i], acc[r][c][i + 1], acc[r][c][i + 2],
            acc[r][c][i + 3]);
    }
  }
  __syncthreads();
  for (int r = tid; r < nr; r += THREADS) {
    float M = NEG_INF;
    for (int x = 0; x < ng; ++x) M = fmaxf(M, s_m[x * RG + r]);
    float L = 0.f;
    for (int x = 0; x < ng; ++x) {
      const float w = exp2f(s_m[x * RG + r] - M);
      s_w[x * RG + r] = w;
      L += w * s_l[x * RG + r];
    }
    s_L[r] = L;
    if (nsplit > 1) {
      part_ml[((hb + r) * nsplit + s) * 2] = M;
      part_ml[((hb + r) * nsplit + s) * 2 + 1] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * d; e += THREADS) {
    const int r = e / d;
    const int dd = e - r * d;
    float A = 0.f;
    for (int x = 0; x < ng; ++x)
      A += s_w[x * RG + r] * s_acc[(x * RG + r) * d + dd];
    if (nsplit > 1)
      part_acc[((hb + r) * nsplit + s) * d + dd] = A;
    else
      from_f(out + (hb + r) * d + dd, A / s_L[r]);
  }
}

// Merge the splits of one (slot, head) by log-sum-exp (log2 units, as the
// partials), ascending split order; grid (H, B). Launched as a programmatic
// dependent of the split pass: it waits here for that grid's end.
template <typename QT>
__global__ void __launch_bounds__(THREADS)
paged_decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, QT* __restrict__ out,
                   int nsplit, int d) {
  extern __shared__ float w[];              // nsplit
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  for (int s = threadIdx.x; s < nsplit; s += THREADS)
    w[s] = exp2f(ml[2 * s] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) L += w[s] * ml[2 * s + 1];
  for (int dd = threadIdx.x; dd < d; dd += THREADS) {
    float A = 0.f;
    for (int s = 0; s < nsplit; ++s)
      A += w[s] * part_acc[(row * nsplit + s) * d + dd];
    from_f(out + row * d + dd, A / L);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ksc, *vsc;
  const int *bt, *ln;
  void* out;
  float *part_acc, *part_ml;
  int b, kvh, rep, d, nb, bs, nsplit, P;
  float scale;
  cudaStream_t stream;
};

// Launch the instance for a.rep and a.d, or (ctas_per_sm given) only report
// how many of its CTAs an SM holds at once.
template <typename QT, typename KT_, bool QUANT, int E, int C, int RG,
          bool PAIR>
int launch_rg(const Args& a, int* ctas_per_sm) {
  using R = typename PoolVec<KT_, E>::R;
  const int nch = a.d / E;
  const int per = (nch + C - 1) / C;
  int lpr = 1;
  while (lpr < per && lpr < 32) lpr <<= 1;
  const int ng = THREADS / lpr;
  const size_t smem = (size_t)smem_bytes<R, QUANT, C>(ng, RG, a.d, a.P);
  auto kern = paged_decode_split<QT, KT_, QUANT, E, C, RG, PAIR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (ctas_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kern, THREADS, smem);
  dim3 grid(a.kvh * ((a.rep + RG - 1) / RG), a.b, a.nsplit);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT_*>(a.kp),
      static_cast<const KT_*>(a.vp), a.ksc, a.vsc, a.bt, a.ln,
      static_cast<QT*>(a.out), a.part_acc, a.part_ml, a.nb, a.bs,
      (a.bs & (a.bs - 1)) ? -1 : __builtin_ctz(a.bs), a.kvh, a.rep, a.d, lpr,
      a.P, a.nsplit, a.scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.kvh * a.rep, a.b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(float) * a.nsplit;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_decode_merge<QT>,
                         (const float*)a.part_acc, (const float*)a.part_ml,
                         static_cast<QT*>(a.out), a.nsplit, a.d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// RG: the smallest power of two >= rep, at most 8 (a lane's query heads and
// accumulators then take 64 registers each).
template <typename QT, typename KT_, bool QUANT, int E, int C, bool PAIR>
int launch_ec(const Args& a, int* occ) {
  static_assert(E * C == 8, "query heads and accumulators: 8 floats a head");
  if (a.rep == 1) return launch_rg<QT, KT_, QUANT, E, C, 1, PAIR>(a, occ);
  if (a.rep == 2) return launch_rg<QT, KT_, QUANT, E, C, 2, PAIR>(a, occ);
  if (a.rep <= 4) return launch_rg<QT, KT_, QUANT, E, C, 4, PAIR>(a, occ);
  return launch_rg<QT, KT_, QUANT, E, C, 8, PAIR>(a, occ);
}

template <typename QT, typename KT_, bool QUANT>
int launch(const Args& a, int* occ = nullptr) {
  if (a.d % 8 != 0 || a.d < 8 || a.d > 256 || a.rep < 1 || a.nsplit < 1 ||
      a.P < 1 || (long long)a.nsplit * a.P < a.nb ||
      (long long)(a.nsplit - 1) * a.P >= a.nb ||
      (a.nsplit > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if constexpr (QUANT) {
    if (a.d % 16 == 0) return launch_ec<QT, KT_, QUANT, 8, 1, true>(a, occ);
    return launch_ec<QT, KT_, QUANT, 8, 1, false>(a, occ);
  } else if constexpr (sizeof(KT_) == 2) {
    return launch_ec<QT, KT_, QUANT, 8, 1, false>(a, occ);
  } else {
    return launch_ec<QT, KT_, QUANT, 4, 2, false>(a, occ);
  }
}

}  // namespace

extern "C" {

// Model-dtype pool; q and the pools share one type: float32 (bf16 = 0) or
// bfloat16 (bf16 = 1). part_acc (B, H, nsplit, D) and part_ml
// (B, H, nsplit, 2) are float32 scratch, unused (may be null) when
// nsplit == 1; the nsplit splits take P blocks each (nsplit * P >= nb >
// (nsplit - 1) * P). Returns the CUDA error code of the launches (0: ok).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const int* block_tables,
                           const int* lengths, void* out, float* part_acc,
                           float* part_ml, int b, int kvh, int rep, int d,
                           int nb, int bs, int nsplit, int P, float scale,
                           int bf16, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, block_tables, lengths,
               out, part_acc, part_ml, b, kvh, rep, d, nb, bs, nsplit, P,
               scale, static_cast<cudaStream_t>(stream)};
  if (bf16) return launch<__nv_bfloat16, __nv_bfloat16, false>(a);
  return launch<float, float, false>(a);
}

// int8 code pools with float32 scale pools; q (and the output) float32
// (bf16 = 0) or bfloat16 (bf16 = 1). Scratch and splits as above.
int paged_attention_quant_launch(const void* q, const void* k_pool,
                                 const void* v_pool, const float* k_scale,
                                 const float* v_scale,
                                 const int* block_tables, const int* lengths,
                                 void* out, float* part_acc, float* part_ml,
                                 int b, int kvh, int rep, int d, int nb,
                                 int bs, int nsplit, int P, float scale,
                                 int bf16, void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
               out, part_acc, part_ml, b, kvh, rep, d, nb, bs, nsplit, P,
               scale, static_cast<cudaStream_t>(stream)};
  if (bf16) return launch<__nv_bfloat16, int8_t, true>(a);
  return launch<float, int8_t, true>(a);
}

// How many CTAs of the split pass's instance for (quant, bf16, rep, d) an
// SM holds at once, into *out; the wrapper's split plan aims at one such
// wave. Returns the CUDA error code (0: ok).
int paged_attention_ctas_per_sm(int quant, int bf16, int rep, int d,
                                int* out) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, 1, 1, rep, d, 1, 1, 1, 1, 1.f,
               nullptr};
  if (quant)
    return bf16 ? launch<__nv_bfloat16, int8_t, true>(a, out)
                : launch<float, int8_t, true>(a, out);
  return bf16 ? launch<__nv_bfloat16, __nv_bfloat16, false>(a, out)
              : launch<float, float, false>(a, out);
}

}  // extern "C"
