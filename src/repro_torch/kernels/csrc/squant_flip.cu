// SQuant progressive flip, E -> K -> C fused, for Hopper (sm_90a).
//
// Replaces BOTH Pallas passes of the reference package,
//   repro/kernels/squant_flip.py : squant_ek_kernel  (round + group flip +
//                                  Algorithm-4 candidate per group) and
//   repro/kernels/squant_flip.py : squant_c_kernel   (+ the +-1 apply that
//                                  squant_pallas does after it),
// with ONE __global__ function: phase 1 is the counterpart of
// squant_ek_kernel, phase 2 of squant_c_kernel and the apply.
//
// What bounds it on this card: bytes. Per element the function must read
// 4 bytes (float32 weight) and write 1 byte (int8 code); the arithmetic is a
// division, a rounding and a few comparisons per element.
//
// What the design does about it: it goes back to the paper's own layout
// instead of the TPU's dense G x G rank-by-comparison. One thread block
// owns one output channel (row); each warp walks the row's groups, a group
// of up to 128 elements held 4 per lane in registers. The group sum is a
// fixed-order warp reduction; the k largest eligible |delta| are found by
// k rounds of a warp arg-max over a (|delta| bits, ~index) key, so ties go
// to the lower index, and k = round(|sum delta|) is a handful. The
// per-group summaries (post-K sum, candidate index and value) stay in
// shared memory, the C phase runs in the same block over them, and the at
// most NG +-1 corrections are applied to the codes the block has just
// written. The (M, N) delta and the (M, NG) summaries that the two-pass
// version moves through device memory never leave the chip.
//
// Arithmetic that decides bit-exactness against the plain version
// (repro_torch/core/squant.py): w / s is an IEEE division (__fdiv_rn), not
// a multiply by a reciprocal; rounding is half-to-even (rintf, not roundf);
// q - w/s and every sum use non-contracted adds (compile with -fmad=false;
// the intrinsics below make it explicit as well). A float32 sum taken in
// another order can move |sum delta| across k + 0.5, so bit-identity is
// guaranteed where sums are exact and holds up to such ties otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int EPL = 4;                 // elements per lane: 32 * 4 = 128 = max group
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;                            // identical bits in every lane
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_max_u64(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u64 t = __shfl_xor_sync(FULL, v, o);
    v = t > v ? t : v;
  }
  return v;
}

__device__ __forceinline__ float sgnf(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

// Larger |value| wins, then the lower index. |value| > 0 for every real key,
// so 0 means "no element".
__device__ __forceinline__ u64 make_key(float absval, int idx) {
  return ((u64)__float_as_uint(absval) << 32) | (u64)(0xffffffffu - (unsigned)idx);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
}

__device__ __forceinline__ float lane_sum4(const float (&d)[EPL]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(d[0], d[1]), d[2]), d[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
squant_flip_kernel(const float* __restrict__ w, const float* __restrict__ scale,
                   int8_t* __restrict__ out, int n, int g, int ng, float qmax,
                   int enable_k, int enable_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_e1 = reinterpret_cast<float*>(smem_raw);       // post-K group sums
  float* s_cval = s_e1 + ng;                              // candidate delta
  int* s_cidx = reinterpret_cast<int*>(s_cval + ng);      // candidate column
  int* s_state = s_cidx + ng;                             // 1 eligible, 2 flip

  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float s = scale[row];
  const float* wrow = w + row * (long long)n;
  int8_t* orow = out + row * (long long)n;
  const int l0 = lane * EPL;           // first in-group index of this lane

  // ---- phase 1: E (+K) per group, candidate for C -------------------------
  for (int grp = warp; grp < ng; grp += WARPS) {
    const int base = grp * g;
    float wv[EPL], q[EPL], d[EPL];
    if (VEC) {
      if (l0 < g && base + l0 < n) {
        const float4 v = *reinterpret_cast<const float4*>(wrow + base + l0);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      } else {
        wv[0] = wv[1] = wv[2] = wv[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int idx = l0 + j;
        wv[j] = (idx < g && base + idx < n) ? wrow[base + idx] : 0.f;
      }
    }
    // SQuant-E. Padding (w = 0) gives q = 0, delta = 0: never eligible.
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const float t = __fdiv_rn(wv[j], s);
      q[j] = fminf(fmaxf(rintf(t), -qmax), qmax);
      d[j] = __fsub_rn(q[j], t);
    }

    if (enable_k) {                    // SQuant-K
      const float e = warp_sum(lane_sum4(d));
      int k = (int)rintf(fabsf(e));
      u64 key[EPL];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const float tgt = q[j] - sgnf(d[j]);
        const bool elig = (__fmul_rn(d[j], e) > 0.f) && tgt >= -qmax && tgt <= qmax;
        key[j] = elig ? make_key(fabsf(d[j]), l0 + j) : 0ull;
        cnt += elig ? 1 : 0;
      }
      cnt = warp_sum_int(cnt);
      k = k < cnt ? k : cnt;
      for (int r = 0; r < k; ++r) {    // k is the same in every lane
        u64 best = key[0];
#pragma unroll
        for (int j = 1; j < EPL; ++j) best = key[j] > best ? key[j] : best;
        best = warp_max_u64(best);
        const int widx = key_index(best);
        if ((widx >> 2) == lane) {
#pragma unroll
          for (int j = 0; j < EPL; ++j) {
            if (j == (widx & 3)) {
              const float sg = sgnf(d[j]);
              key[j] = 0ull;
              q[j] = q[j] - sg;
              d[j] = __fsub_rn(d[j], sg);
            }
          }
        }
      }
    }

    if (enable_c) {                    // post-K sum and Algorithm-4 candidate
      const float e1 = warp_sum(lane_sum4(d));
      const float sg1 = sgnf(e1);
      u64 best = 0ull;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const float dj = d[j];
        const bool match = (sg1 == 0.f) ? (dj != 0.f) : (__fmul_rn(dj, sg1) > 0.f);
        const float tgt = q[j] - sgnf(dj);
        if (match && tgt >= -qmax && tgt <= qmax) {
          const u64 kj = make_key(fabsf(dj), l0 + j);
          best = kj > best ? kj : best;
        }
      }
      best = warp_max_u64(best);
      const bool has = best != 0ull;
      const int widx = has ? key_index(best) : 0;
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) if (j == (widx & 3)) mine = d[j];
      const float cv = __shfl_sync(FULL, mine, widx >> 2);
      if (lane == 0) {
        s_e1[grp] = e1;
        s_cidx[grp] = has ? base + widx : -1;
        s_cval[grp] = has ? cv : 0.f;
      }
    }

    if (VEC) {
      if (l0 < g && base + l0 < n) {
        char4 c;
        c.x = (signed char)q[0]; c.y = (signed char)q[1];
        c.z = (signed char)q[2]; c.w = (signed char)q[3];
        *reinterpret_cast<char4*>(orow + base + l0) = c;
      }
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int idx = l0 + j;
        if (idx < g && base + idx < n) orow[base + idx] = (int8_t)q[j];
      }
    }
  }

  // ---- phase 2: SQuant-C over the row's group summaries --------------------
  if (enable_c) {
    __syncthreads();                   // summaries and codes of all warps
    if (warp == 0) {
      float part = 0.f;
      for (int i = lane; i < ng; i += 32) part = __fadd_rn(part, s_e1[i]);
      const float e_row = warp_sum(part);
      int kc = (int)rintf(fabsf(e_row));
      int cnt = 0;
      for (int i = lane; i < ng; i += 32) {
        const bool elig = __fmul_rn(s_cval[i], e_row) > 0.f;   // cval 0: no candidate
        s_state[i] = elig ? 1 : 0;
        cnt += elig ? 1 : 0;
      }
      cnt = warp_sum_int(cnt);
      kc = kc < cnt ? kc : cnt;
      for (int r = 0; r < kc; ++r) {
        u64 best = 0ull;
        for (int i = lane; i < ng; i += 32) {
          if (s_state[i] == 1) {
            const u64 ki = make_key(fabsf(s_cval[i]), i);
            best = ki > best ? ki : best;
          }
        }
        best = warp_max_u64(best);
        const int gi = key_index(best);
        if ((gi & 31) == lane) s_state[gi] = 2;   // entry gi belongs to this lane
      }
      for (int i = lane; i < ng; i += 32) {
        if (s_state[i] == 2) {
          const int c = s_cidx[i];
          orow[c] = (int8_t)((int)orow[c] - (int)sgnf(s_cval[i]));
        }
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int squant_flip_launch(const void* w, const void* scale, void* out,
                                  long long m, int n, int g, int bits,
                                  int enable_k, int enable_c, void* stream) {
  const int ng = (n + g - 1) / g;
  const size_t smem = (size_t)ng * 16;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const bool vec = (n % 4 == 0) && (g % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const dim3 grid((unsigned)m);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    squant_flip_kernel<true><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(scale),
        static_cast<int8_t*>(out), n, g, ng, qmax, enable_k, enable_c);
  } else {
    squant_flip_kernel<false><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(scale),
        static_cast<int8_t*>(out), n, g, ng, qmax, enable_k, enable_c);
  }
  return (int)cudaGetLastError();
}
