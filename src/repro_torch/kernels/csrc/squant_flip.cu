// SQuant progressive flip, E -> K -> C fused, for Hopper (sm_90a), and the
// per-channel max scale of the weights it quantizes.
//
// Replaces BOTH Pallas passes of the reference package,
//   repro/kernels/squant_flip.py : squant_ek_kernel  (round + group flip +
//                                  Algorithm-4 candidate per group) and
//   repro/kernels/squant_flip.py : squant_c_kernel   (+ the +-1 apply that
//                                  squant_pallas does after it),
// with ONE __global__ function, squant_flip_kernel: phase 1 is the
// counterpart of squant_ek_kernel, phase 2 of squant_c_kernel and the apply.
// squant_scale_kernel computes the scales the flip divides by (the
// reference computes them with jnp ops, not a Pallas kernel).
//
// What bounds it on this card: bytes. Per element the function must read
// 4 bytes (float32 weight) and write 1 byte (int8 code); the arithmetic is a
// division, a rounding, a few comparisons and, per group, k = round(|sum|)
// warp-wide arg-max rounds (k is ~2.6 on average at 128-element groups) --
// enough that the issue of those instructions, not the bytes, is what
// holds this kernel back (PERF.md).
//
// Where the weights come from. A dense leaf is stored (in, out): output
// channel c is the COLUMN w[:, c], strided by `out` floats. The kernel reads
// leaves where and as they are stored, through a table of the bucket's leaf
// pointers in the kernel's parameters (one launch per bucket), so nothing
// transposes or stacks the tree before it. A row-major (M, N) matrix is the
// same function with the strides swapped (the `sc`, `sk` element strides).
//
// What the design does about bytes and latency:
// * One CTA owns TC = 32 output channels of one leaf and walks all of their
//   groups. A producer warp keeps NSTAGE slabs of up to 128 input rows x 32
//   channels in flight in a shared-memory ring (mbarriers: full / empty per
//   stage), by cp.async: 16 bytes a copy where the rows are 16-byte aligned
//   (out % 4 == 0), else 4 bytes, and for the row-major layout 4 bytes along
//   the rows. Eight consumer warps run the E/K/C chain of one slab while the
//   next slabs' bytes arrive. (The TMA unit in its bulk mode, one 128-byte
//   copy per staged row, moved these slabs at less than half the rate.)
// * The transpose happens in shared memory. Staged row r lies at byte
//   (r/4)*528 + (r%4)*128: rows of 32 floats, and 16 bytes of skew every
//   four rows. Consumer warp w takes channels 4w..4w+3; lane l reads the
//   float4 of those channels in rows 4l..4l+3 of a group. Within a quarter
//   warp (8 lanes) the eight 16-byte reads start at 16-byte units
//   33*l + w (+8j), distinct modulo 8: no bank conflict.
// * Each warp therefore holds four channels of a group at once (16 elements
//   a lane) and runs their butterflies and C candidates side by side. Three
//   CTAs (24 consumer warps) an SM, each with a ring of two slabs.
// * The chain is short in instructions, because the issue of instructions
//   is what limits the kernel: whether a flip target stays on the grid is
//   one "clipped" bit per element, set in E; codes are kept as four packed
//   bytes a channel, the form they are stored in; an element's key packs
//   the |delta| bits above its position, and a lane sorts its four keys
//   once; an arg-max round is one warp max of the lanes' best keys
//   (`redux.sync`) and one ballot of the lanes holding the value: lane l
//   holds in-group elements 4l..4l+3, so the lowest lane of the ballot holds
//   the lowest index, and ties go to it without a second reduction.
// * Phase C stays in the warp that owns the channels: per-channel, per-group
//   summaries (post-K sum, candidate value, candidate index and code) are 12
//   bytes in shared memory (global scratch above NG_SMEM groups), and the at
//   most NG +-1 corrections go to codes the warp itself wrote.
//
// Arithmetic that decides bit-exactness against the plain version
// (repro_torch/core/squant.py), unchanged from the first port: w / s is an
// IEEE division (__fdiv_rn), not a multiply by a reciprocal; rounding is
// half-to-even (rintf, not roundf); q - w/s and every sum use non-contracted
// adds (compiled with -fmad=false; the intrinsics make it explicit as well);
// a group sum is the four elements 4l..4l+3 of lane l added in order, then
// the xor butterfly over the lanes; a row sum is each lane's groups
// l, l+32, ... added in order, then the butterfly. A float32 sum taken in
// another order can move |sum delta| across k + 0.5, so bit-identity with
// the plain version is guaranteed where sums are exact and holds up to such
// ties otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TC = 32;                   // output channels per CTA
constexpr int CWARPS = TC / 4;           // consumer warps, four channels each
constexpr int THREADS = (CWARPS + 1) * 32;   // + the producer warp
constexpr int SLAB = 128;                // input rows per ring stage
constexpr int ROW_BYTES = TC * 4;        // one staged row: 32 float32
constexpr int BLK = 4 * ROW_BYTES + 16;  // four staged rows + the skew
constexpr int STAGE_BYTES = SLAB / 4 * BLK;
constexpr int NSTAGE = 2;
constexpr int BAR_BYTES = 64;            // 2 * NSTAGE mbarriers, padded
constexpr int NG_SMEM = 128;             // summaries in shared memory up to here
constexpr int SUMM_BYTES = 12;           // e1, cval, meta per (channel, group)
constexpr int MAX_LEAVES = 384;          // leaf pointers in one launch's table
constexpr unsigned FULL = 0xffffffffu;

struct FlipArgs {
  const float* w[MAX_LEAVES];            // leaf base pointers
  const float* scale;                    // (leaves, nch) float32
  int8_t* out;                           // (leaves, nch, kin) int8
  unsigned char* scratch;                // summaries when ng > NG_SMEM
  long long sc, sk;                      // element (c, k) at w[c*sc + k*sk]
  int nch, kin, g, ng, gps, tiles;       // gps: groups per ring stage
  float qmax;
  int enable_k, enable_c;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;                              // identical bits in every lane
}

__device__ __forceinline__ float sgnf(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float lane_sum4(const float (&d)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(d[0], d[1]), d[2]), d[3]);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Among the lanes' candidates (bits of |value|, 0 = none; `at` its index),
// the index of the largest value, the lowest index on a tie; FULL if no lane
// has one. `best` returns the largest bits.
__device__ __forceinline__ unsigned warp_argmax(unsigned bits, unsigned at,
                                                unsigned& best) {
  best = __reduce_max_sync(FULL, bits);
  return __reduce_min_sync(FULL, best != 0u && bits == best ? at : FULL);
}

// An element's arg-max key within its lane: the bits of |delta| (which
// order like the values; a candidate's |delta| is at most 1, so the top two
// bits are free) above 3 - j, so the larger value wins and then the lower
// position. Only candidates get a key; 0 means none.
__device__ __forceinline__ unsigned elem_key(float dj, int j) {
  return abs_bits(dj) << 2 | (unsigned)(3 - j);
}

__device__ __forceinline__ void sort_desc(unsigned& a, unsigned& b) {
  const unsigned hi = max(a, b);
  b = min(a, b);
  a = hi;
}

// Whether this lane is the lowest of the ballot `own`. Lane l holds in-group
// elements 4l..4l+3, so the lowest lane holding the warp's largest value,
// at its own lowest position, holds the lowest index that has it.
__device__ __forceinline__ bool lowest_lane(unsigned own, int lane) {
  return (own & (0u - own)) == 1u << lane;
}

// w / s, IEEE round to nearest (div.rn). Volatile, so that the compiler
// computes each quotient once and never recomputes it later to save the
// registers that hold its results.
__device__ __forceinline__ float div_rn(float w, float s) {
  float t;
  asm volatile("div.rn.f32 %0, %1, %2;" : "=f"(t) : "f"(w), "f"(s));
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ int row_off(int r) {
  return (r >> 2) * BLK + (r & 3) * ROW_BYTES;
}

// V16: the leaf's rows are copied 16 bytes at a time (sc == 1,
// nch % 4 == 0, 16-byte aligned leaves); otherwise 4 bytes at a time.
// Grid: leaves x tiles, tiles = ceil(nch / TC).
template <bool V16>
__global__ void __launch_bounds__(THREADS, 3)
squant_flip_kernel(const __grid_constant__ FlipArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + BAR_BYTES;
  const int leaf = blockIdx.x / a.tiles;
  const int c0 = (blockIdx.x - leaf * a.tiles) * TC;
  const int nc = min(TC, a.nch - c0);            // channels of this tile
  const float* w = a.w[leaf];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab_rows = a.gps * a.g;
  const int nslab = (a.ng + a.gps - 1) / a.gps;
  const unsigned bar0 = smem_u32(smem);          // full[s], then empty[s]
  const unsigned ring0 = smem_u32(ring);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar0 + 8 * s, 32);             // the producer's lanes
      mbar_init(bar0 + 8 * (NSTAGE + s), CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer warp ----------------------------------------------------
  if (warp == CWARPS) {
    for (int s = 0; s < nslab; ++s) {
      const int st = s % NSTAGE;
      if (s >= NSTAGE) mbar_wait(bar0 + 8 * (NSTAGE + st), ((s / NSTAGE) & 1) ^ 1);
      const long long k0 = (long long)s * slab_rows;
      const int rows = (int)min((long long)slab_rows, (long long)a.kin - k0);
      const unsigned dst = ring0 + st * STAGE_BYTES;
      const unsigned full = bar0 + 8 * st;
      if (V16) {                                 // nc % 4 == 0
        const int nv = nc >> 2;                  // 16-byte pieces of a row
        for (int v = lane; v < rows * nv; v += 32) {
          const int r = nv == TC / 4 ? v / (TC / 4) : v / nv;
          const int c = (v - r * nv) * 4;
          cp16(dst + row_off(r) + c * 4, w + (k0 + r) * a.sk + c0 + c);
        }
      } else {
        if (a.sc == 1) {                         // lanes along the channels
          if (lane < nc)
            for (int r = 0; r < rows; ++r)
              cp4(dst + row_off(r) + lane * 4, w + (k0 + r) * a.sk + c0 + lane);
        } else {                                 // lanes along the inputs
          for (int c = 0; c < nc; ++c)
            for (int r = lane; r < rows; r += 32)
              cp4(dst + row_off(r) + c * 4,
                  w + (long long)(c0 + c) * a.sc + (k0 + r) * a.sk);
        }
      }
      cp_arrive(full);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the consumer warps: channels cw..cw+3 of the tile ---------------------
  const int cw = warp * 4;
  const bool live = cw < nc;
  const float qmax = a.qmax;
  const long long ch0 = (long long)leaf * a.nch + c0 + cw;   // first channel
  int8_t* const out0 = a.out + ch0 * a.kin;      // its codes; channel i's
                                                 // start a.kin bytes apart
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = cw + i < nc ? a.scale[ch0 + i] : 1.f;
  const int ng = a.ng;
  unsigned char* sbase = ng <= NG_SMEM
      ? ring + NSTAGE * STAGE_BYTES
      : a.scratch + (long long)blockIdx.x * TC * ng * SUMM_BYTES;
  float* e1p = reinterpret_cast<float*>(sbase);             // post-K group sum
  float* cvp = e1p + TC * ng;                               // candidate delta
  unsigned* mtp = reinterpret_cast<unsigned*>(cvp + TC * ng);  // index | code
                                                            // << 8 | state << 16
  const bool vstore = (a.kin % 4 == 0) && (a.g % 4 == 0);
  const int l0 = lane * 4;                       // first in-group index of lane

  for (int sl = 0; sl < nslab; ++sl) {
    const int st = sl % NSTAGE;
    mbar_wait(bar0 + 8 * st, (sl / NSTAGE) & 1);
    const unsigned char* stage = ring + st * STAGE_BYTES;
    for (int qg = 0; live && qg < a.gps; ++qg) {
      const int grp = sl * a.gps + qg;
      if (grp >= ng) break;
      const long long kb = (long long)grp * a.g;   // first input of the group
      const int ro = qg * a.g;                     // its first staged row
      // codes as four signed bytes a channel (byte j: element 4l+j), the
      // form they are stored in; deltas as floats
      unsigned qp[4] = {0u, 0u, 0u, 0u};
      float d[4][4];
      // bit 4i+j: |w/s| > qmax. A flip target q - sign(delta) leaves the
      // grid exactly for these clipped elements (an unclipped q is rint(t)
      // with |q - t| <= 1/2, and a K-flipped one moves back toward t).
      unsigned clip = 0u;
      bool vj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = l0 + j;
        vj[j] = idx < a.g && kb + idx < a.kin;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (vj[j])
          v = *reinterpret_cast<const float4*>(stage + row_off(ro + idx) + cw * 4);
        const float x[4] = {v.x, v.y, v.z, v.w};
        // SQuant-E. Padding (w = 0) gives q = 0, delta = 0: never eligible.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float t = div_rn(V16 || cw + i < nc ? x[i] : 0.f, s[i]);
          const float q = fminf(fmaxf(rintf(t), -qmax), qmax);
          d[i][j] = __fsub_rn(q, t);
          clip |= fabsf(t) > qmax ? 1u << (4 * i + j) : 0u;
          qp[i] |= ((unsigned)(int)q & 0xffu) << (8 * j);
        }
      }

      if (a.enable_k) {                          // SQuant-K
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = warp_sum(lane_sum4(d[i]));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned key[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool el = (__fmul_rn(d[i][j], e[i]) > 0.f) &
                            !((clip >> (4 * i + j)) & 1u);
            key[j] = el ? elem_key(d[i][j], j) : 0u;
          }
          // Round r flips the largest eligible |delta| (the lowest index on
          // a tie); a round with none left ends them, so a channel flips
          // min(k, eligible). A lane only ever gives up its own largest
          // key, so it sorts its four keys once (s0 >= s1 >= s2 >= s3) and
          // a round shifts the owning lane's list; the flipped elements are
          // then the keys above what is left at its head. Every array index
          // is a constant: the compiler must not be given a branch on a
          // chosen element, which it would merge into an indexed access and
          // so move the arrays to local memory.
          const int k = (int)rintf(fabsf(e[i]));   // the same in every lane
          unsigned s0 = key[0], s1 = key[1], s2 = key[2], s3 = key[3];
          sort_desc(s0, s1);
          sort_desc(s2, s3);
          sort_desc(s0, s2);
          sort_desc(s1, s3);
          sort_desc(s1, s2);
          for (int r = 0; r < k; ++r) {
            const unsigned m = __reduce_max_sync(FULL, s0);
            if (m == 0u) break;
            const bool mine =
                lowest_lane(__ballot_sync(FULL, (s0 ^ m) < 4u), lane);
            s0 = mine ? s1 : s0;
            s1 = mine ? s2 : s1;
            s2 = mine ? s3 : s2;
            s3 = mine ? 0u : s3;
          }
          unsigned fl = 0u;                      // bit j: element 4l+j flips
#pragma unroll
          for (int j = 0; j < 4; ++j) fl |= key[j] > s0 ? 1u << j : 0u;
          const float sg = e[i] > 0.f ? 1.f : -1.f;  // a flipped delta's sign
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float f = (fl >> j) & 1u ? sg : 0.f;
            d[i][j] = __fsub_rn(d[i][j], f);
          }
          // q - sign in each flipped byte (bit j of fl spread to byte j); a
          // flipped code stays in [-qmax, qmax]
          const unsigned ones = (fl * 0x204081u) & 0x01010101u;
          qp[i] = sg > 0.f ? __vsub4(qp[i], ones) : __vadd4(qp[i], ones);
        }
      }

      if (a.enable_c) {                          // post-K sum and candidate
        float e1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e1[i] = warp_sum(lane_sum4(d[i]));
        float cv[4];
        unsigned cp[4], own[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // Algorithm 4: the largest |delta| whose sign matches the group
          // sum's (any nonzero delta when the sum is 0), on the grid
          unsigned key[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dj = d[i][j];
            // delta's sign is the sum's (any nonzero delta when the sum
            // is 0), compared on the sign bits; & and |, not && and ||,
            // which the compiler turns into branches
            const bool match =
                (dj != 0.f) &
                ((e1[i] == 0.f) |
                 ((__float_as_uint(dj) ^ __float_as_uint(e1[i])) < 0x80000000u));
            key[j] = match & !((clip >> (4 * i + j)) & 1u)
                         ? elem_key(dj, j) : 0u;
          }
          const unsigned lk = max(max(key[0], key[1]), max(key[2], key[3]));
          const unsigned m = __reduce_max_sync(FULL, lk);
          own[i] = __ballot_sync(FULL, m != 0u && (lk >> 2) == (m >> 2));
          // the owning lane's delta, and its index and code packed
          const unsigned jb = 3u - (lk & 3u);
          const float md = jb & 2u ? (jb & 1u ? d[i][3] : d[i][2])
                                   : (jb & 1u ? d[i][1] : d[i][0]);
          const unsigned pk = ((unsigned)l0 + jb) |
                              ((qp[i] >> (8 * jb)) & 0xffu) << 8;
          const int src = (__ffs(own[i]) - 1) & 31;
          cv[i] = __shfl_sync(FULL, md, src);
          cp[i] = __shfl_sync(FULL, pk, src);
        }
        if (lane < 4) {                          // lane i: channel i's summary
          const bool l1 = lane & 1, l2 = lane & 2;
          const unsigned ow = l2 ? (l1 ? own[3] : own[2]) : (l1 ? own[1] : own[0]);
          const int si = (cw + lane) * ng + grp;
          e1p[si] = l2 ? (l1 ? e1[3] : e1[2]) : (l1 ? e1[1] : e1[0]);
          cvp[si] = ow == 0u ? 0.f : l2 ? (l1 ? cv[3] : cv[2])
                                        : (l1 ? cv[1] : cv[0]);
          mtp[si] = ow == 0u ? 0xffu : l2 ? (l1 ? cp[3] : cp[2])
                                          : (l1 ? cp[1] : cp[0]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {              // the codes
        if (cw + i >= nc) continue;
        int8_t* o = out0 + i * (long long)a.kin + kb + l0;
        if (vstore) {
          if (vj[0]) *reinterpret_cast<unsigned*>(o) = qp[i];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (vj[j]) o[j] = (int8_t)(qp[i] >> (8 * j));
        }
      }
    }
    __syncwarp();                                // the stage is read
    if (lane == 0) mbar_arrive(bar0 + 8 * (NSTAGE + st));
  }

  // ---- phase 2: SQuant-C over each channel's group summaries ----------------
  if (!live || !a.enable_c) return;
  __syncwarp();                                  // summaries and codes
#pragma unroll 1
  for (int i = 0; i < 4 && cw + i < nc; ++i) {
    int8_t* const oc = out0 + i * (long long)a.kin;
    const float* e1c = e1p + (cw + i) * ng;
    const float* cvc = cvp + (cw + i) * ng;
    unsigned* mtc = mtp + (cw + i) * ng;
    float part = 0.f;
    for (int gi = lane; gi < ng; gi += 32) part = __fadd_rn(part, e1c[gi]);
    const float e_row = warp_sum(part);
    int cnt = 0;
    for (int gi = lane; gi < ng; gi += 32) {     // group gi is lane gi % 32's
      const bool el = __fmul_rn(cvc[gi], e_row) > 0.f;   // cval 0: none
      mtc[gi] = (mtc[gi] & 0xffffu) | (el ? 0x10000u : 0u);
      cnt += el ? 1 : 0;
    }
    const int tot = (int)__reduce_add_sync(FULL, (unsigned)cnt);
    int kc = (int)rintf(fabsf(e_row));
    kc = kc < tot ? kc : tot;
    for (int r = 0; r < kc; ++r) {
      unsigned bb = 0u, gb = FULL, m;
      for (int gi = lane; gi < ng; gi += 32) {
        if ((mtc[gi] >> 16) == 1u) {
          const unsigned b = abs_bits(cvc[gi]);
          if (b > bb) { bb = b; gb = (unsigned)gi; }
        }
      }
      const unsigned gs = warp_argmax(bb, gb, m);
      if ((int)(gs & 31u) == lane) mtc[gs] = (mtc[gs] & 0xffffu) | 0x20000u;
    }
    for (int gi = lane; gi < ng; gi += 32) {
      const unsigned mt = mtc[gi];
      if ((mt >> 16) == 2u) {
        const int code = (int)(signed char)((mt >> 8) & 0xffu);
        oc[(long long)gi * a.g + (mt & 0xffu)] =
            (int8_t)(code - (int)sgnf(cvc[gi]));
      }
    }
  }
}

// ---- the scale pass -----------------------------------------------------------

constexpr int SC_COLS = 64;              // output channels per CTA
constexpr int SC_THREADS = 256;          // 16 row slots x 16 lanes of 4 columns
constexpr int SC_SLOTS = SC_THREADS / 16;
constexpr int SC_UNROLL = 4;

struct ScaleArgs {
  const float* w[MAX_LEAVES];
  float* scale;                          // (leaves, nch)
  int nch, kin, tiles;
  float inv_qmax, eps;
};

// scale[c] = max(max_k |w[k, c]|, eps) * inv_qmax over one (in, out) leaf:
// the max is taken on the bits of |w| (ordered like the values, NaN above
// every number, so a NaN propagates as torch's amax propagates it), and the
// product is one float32 multiply, as `clamp_min(absmax, eps) * (1 / qmax)`
// is in torch. VEC: nch % 4 == 0 and 16-byte aligned leaves.
template <bool VEC>
__global__ void __launch_bounds__(SC_THREADS)
squant_scale_kernel(const __grid_constant__ ScaleArgs a) {
  __shared__ unsigned red[SC_SLOTS][SC_COLS];
  const int leaf = blockIdx.x / a.tiles;
  const int c0 = (blockIdx.x - leaf * a.tiles) * SC_COLS;
  const float* w = a.w[leaf];
  const int t = threadIdx.x;
  const int slot = t >> 4;
  const long long ld = a.nch;
  unsigned mx[4] = {0u, 0u, 0u, 0u};
  int col[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    col[e] = VEC ? (t & 15) * 4 + e : (t & 15) + 16 * e;
  if (VEC) {
    if (c0 + col[0] < a.nch) {                   // all four columns or none
      const float* p = w + c0 + col[0];
      int r = slot;
      for (; r + SC_SLOTS * (SC_UNROLL - 1) < a.kin; r += SC_SLOTS * SC_UNROLL) {
        float4 v[SC_UNROLL];
#pragma unroll
        for (int u = 0; u < SC_UNROLL; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              p + (long long)(r + SC_SLOTS * u) * ld));
#pragma unroll
        for (int u = 0; u < SC_UNROLL; ++u) {
          mx[0] = max(mx[0], abs_bits(v[u].x));
          mx[1] = max(mx[1], abs_bits(v[u].y));
          mx[2] = max(mx[2], abs_bits(v[u].z));
          mx[3] = max(mx[3], abs_bits(v[u].w));
        }
      }
      for (; r < a.kin; r += SC_SLOTS) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p + (long long)r * ld));
        mx[0] = max(mx[0], abs_bits(v.x));
        mx[1] = max(mx[1], abs_bits(v.y));
        mx[2] = max(mx[2], abs_bits(v.z));
        mx[3] = max(mx[3], abs_bits(v.w));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c0 + col[e] >= a.nch) continue;
      const float* p = w + c0 + col[e];
      for (int r = slot; r < a.kin; r += SC_SLOTS)
        mx[e] = max(mx[e], abs_bits(__ldg(p + (long long)r * ld)));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[slot][col[e]] = mx[e];
  __syncthreads();
  if (t < SC_COLS && c0 + t < a.nch) {
    unsigned m = __float_as_uint(a.eps);
#pragma unroll
    for (int sl = 0; sl < SC_SLOTS; ++sl) m = max(m, red[sl][t]);
    a.scale[(long long)leaf * a.nch + c0 + t] = __fmul_rn(__uint_as_float(m), a.inv_qmax);
  }
}

// Sets a kernel's dynamic-shared-memory limit once per device (a race sets
// it twice, harmlessly); `ready` is the kernel's own bitmask of devices.
template <typename Kernel>
int smem_attr_once(Kernel kern, int smem,
                   std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

constexpr int MAX_SMEM = BAR_BYTES + NSTAGE * STAGE_BYTES +
                         TC * NG_SMEM * SUMM_BYTES;

}  // namespace

extern "C" {

// Leaves the kernel's table takes per launch, and the scratch bytes a
// launch needs for its group summaries (0 when they fit shared memory).
int squant_flip_max_leaves() { return MAX_LEAVES; }

long long squant_flip_scratch_bytes(int nleaf, int nch, int kin, int g) {
  const int ng = (kin + g - 1) / g;
  if (ng <= NG_SMEM) return 0;
  const long long tiles = (nch + TC - 1) / TC;
  return (long long)nleaf * tiles * TC * ng * SUMM_BYTES;
}

// SQuant codes of `nleaf` matrices of nch output channels x kin inputs,
// element (c, k) of leaf b at leaves[b][c*sc + k*sk]: scale (nleaf, nch)
// float32, out (nleaf, nch, kin) int8, scratch as squant_flip_scratch_bytes
// says. v16 = 1 asks for the 16-byte instance (sc == 1, nch % 4 == 0,
// 16-byte aligned leaves; refused with cudaErrorInvalidValue otherwise).
// Returns the
// CUDA error of the launch (0 on success). Launches on `stream`, allocates
// nothing, does not synchronise.
int squant_flip_launch(const void* const* leaves, int nleaf, const void* scale,
                       void* out, void* scratch, long long sc, long long sk,
                       int nch, int kin, int g, int bits, int enable_k,
                       int enable_c, int v16, void* stream) {
  if (nleaf < 1 || nleaf > MAX_LEAVES || g < 1 || g > SLAB || nch < 1 ||
      kin < 1 || bits < 2 || bits > 8)
    return (int)cudaErrorInvalidValue;
  FlipArgs a;
  for (int b = 0; b < nleaf; ++b) {
    a.w[b] = static_cast<const float*>(leaves[b]);
    if (v16 && reinterpret_cast<uintptr_t>(leaves[b]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  }
  if (v16 && (sc != 1 || nch % 4 != 0 || sk != nch))
    return (int)cudaErrorInvalidValue;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<int8_t*>(out);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.sc = sc;
  a.sk = sk;
  a.nch = nch;
  a.kin = kin;
  a.g = g;
  a.ng = (kin + g - 1) / g;
  a.gps = SLAB / g;
  a.tiles = (nch + TC - 1) / TC;
  a.qmax = (float)((1 << (bits - 1)) - 1);
  a.enable_k = enable_k;
  a.enable_c = enable_c;
  if (a.ng > NG_SMEM && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = BAR_BYTES + NSTAGE * STAGE_BYTES +
                   (a.ng <= NG_SMEM ? TC * a.ng * SUMM_BYTES : 0);
  const dim3 grid((unsigned)((long long)nleaf * a.tiles));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int e;
  if (v16) {
    static std::atomic<unsigned long long> ready{0};
    if ((e = smem_attr_once(squant_flip_kernel<true>, MAX_SMEM, ready)) != 0)
      return e;
    squant_flip_kernel<true><<<grid, THREADS, smem, st>>>(a);
  } else {
    static std::atomic<unsigned long long> ready{0};
    if ((e = smem_attr_once(squant_flip_kernel<false>, MAX_SMEM, ready)) != 0)
      return e;
    squant_flip_kernel<false><<<grid, THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// scale (nleaf, nch) float32 of `nleaf` (kin, nch) row-major leaves:
// max(max_k |w[k, c]|, eps) * inv_qmax. Same contract as above.
int squant_scale_launch(const void* const* leaves, int nleaf, void* scale,
                        int nch, int kin, float inv_qmax, float eps,
                        void* stream) {
  if (nleaf < 1 || nleaf > MAX_LEAVES || nch < 1 || kin < 1)
    return (int)cudaErrorInvalidValue;
  ScaleArgs a;
  bool vec = nch % 4 == 0;
  for (int b = 0; b < nleaf; ++b) {
    a.w[b] = static_cast<const float*>(leaves[b]);
    vec = vec && reinterpret_cast<uintptr_t>(leaves[b]) % 16 == 0;
  }
  a.scale = static_cast<float*>(scale);
  a.nch = nch;
  a.kin = kin;
  a.tiles = (nch + SC_COLS - 1) / SC_COLS;
  a.inv_qmax = inv_qmax;
  a.eps = eps;
  const dim3 grid((unsigned)((long long)nleaf * a.tiles));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec)
    squant_scale_kernel<true><<<grid, SC_THREADS, 0, st>>>(a);
  else
    squant_scale_kernel<false><<<grid, SC_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
