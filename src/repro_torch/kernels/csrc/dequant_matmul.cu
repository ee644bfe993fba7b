// Quantized-weight matmul  y[B, M] = x[B, N] @ (codes[M, N] * scale)^T  for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package,
//   repro/kernels/dequant_matmul.py : _dequant_matmul_kernel
// (wrapper dequant_matmul_pallas). Codes are int8, or two 4-bit nibbles per
// byte (low nibble = even column, sign-extended by arithmetic shifts);
// scales are float32, one per output row (M, 1) or one per row and group of
// `gs` columns (M, N/gs). x is float32 or bfloat16, accumulation is float32,
// y has x's type. Each group's partial dot product is multiplied by its
// scale after the dot, as the reference kernel does. The product is
// computed here, in the kernel's own body: codes are widened in registers
// and no dequantized weight is ever written to device memory.
//
// Six variants behind one entry point. Which one takes a launch is decided
// by one rule on shapes, types and alignment, stated once in the wrapper
// (repro_torch/kernels/dequant_matmul.py: variant) and passed in as
// `variant`; each variant here refuses (cudaErrorInvalidValue) a launch it
// cannot take, it never picks another.
//
// float32 x on the tensor cores (variants "tcgemv32" and "mma32": the
// float32 instances of tcgemv_kernel and pf_kernel below). A code (|c| <=
// 127, or <= 7 for nibbles) is exact in bf16, and a float32 x is exactly
// hi + mid + lo with hi = bf16_rn(x), mid = bf16_rn(x - hi), lo =
// bf16_rn(x - hi - mid) (each remainder is exact in float32, and bf16 has
// float32's exponent range; exact for |x| >= 2^-110, the remainders'
// last bit then lies above bf16's smallest subnormal), so each product c *
// hi, c * mid, c * lo is exact in float32. Three bf16 passes accumulating
// in float32 into one accumulator, hi then mid then lo at every k16 step,
// give float32's dot product in another order of summation: x is never
// rounded to bf16 or TF32 as one pass. Both instances widen a code once
// for the three passes. Their bound: max(bytes / 3.35 TB/s, 3 * 2*B*M*N /
// 989 TFLOP/s), three times the bf16 instance's operations.
//
// * tcgemv_kernel (bfloat16 x, B <= SMALL_BATCH_MAX: every decode linear).
//   Bound by bytes: M*N code bytes (M*N/2 packed) must cross from device
//   memory once, 2*B*M*N operations are nothing to the tensor cores. What
//   held the CUDA-core design below to a fifth of that bound was
//   instruction issue and shared-memory traffic, not bytes: an I2F and B
//   float FMAs per code, 16 bytes of float32 x read from shared memory per
//   code byte. So here
//   - the products go to the tensor cores: mma.sync m16n8k16, bf16 in,
//     float32 accumulate, 16 weight rows as the M side, the batch padded to
//     8 (or 16: two n-tiles) as the N side;
//   - the order of summation inside a k-range is free, so a lane takes 16
//     contiguous code bytes of each of its rows as its A fragments over 4
//     k16 steps (int8; 8 steps of nibbles when packed) and x in the
//     matching order; codes widen exactly to bf16 by byte permutes and one
//     magic-number subtraction (int8: into 2^23's mantissa, then the upper
//     half of the float32; int4: into 128's mantissa, then one bf16x2
//     subtraction), never one I2F per code. A k-range (64 columns, 128
//     packed) lies inside one scale group;
//   - bytes in flight: each lane copies its 16-byte code vectors, its x
//     vectors and, at a group's start, its rows' scales by cp.async into
//     its own slots of a ring of TC_NSTAGE stages, TC_NSTAGE - 1 k-ranges
//     ahead of the one it computes (about 10 KB of codes per warp, 40 KB
//     per CTA). A lane reads back only what it copied, so the ring needs no
//     barrier. Codes stream past L1 with a 128-byte L2 prefetch hint; x is
//     cached in L1, where the CTA's four warps share it;
//   - x is read once per TC_ROWS = 128 output rows (2*B/128 of the code
//     bytes at B = 8), not once per 16;
//   - shapes that cannot fill the card split K: the wrapper's split_plan
//     (shapes, SM count and occupancy only) gives each of `splits` CTAs
//     per row tile `gps` whole scale groups; the partials go to float32
//     scratch and a second launch, a programmatic dependent of the first,
//     adds them in ascending split order. No atomics: the output bits are
//     the same run to run, and the launches capture in a CUDA graph.
//   The float32 instance (id "tcgemv32", the same rule on shapes and
//   alignment) copies x as float32 (16-byte vectors, twice bf16's), splits
//   it in registers into the three bf16 B fragments, and issues three
//   mma.sync per k16 step on one A fragment (the widened codes); its ring
//   has as many stages as fit the bf16 int8 one-n-tile instance's bytes
//   (TC_F32_RING: two CTAs an SM where they fit), at least three.
//
// * gemv_kernel (float32 or bfloat16 x that the tensor-core instances do
//   not take: misaligned x or codes, groups that are not whole k-ranges;
//   B <= SMALL_BATCH_MAX; the first port's body). CUDA cores, float32
//   throughout: a block of 8 warps owns 16 output rows, stages up to 1024
//   columns of x for all its batch rows in shared memory, and each lane
//   reads one aligned 32-bit word of codes (16 bits when packed) per
//   128-column step. All of a chunk's
//   code words are requested before x is staged. A 128-column step lies
//   inside one scale group, so the scale multiplies the lane's partial dot
//   product once per step. Partial sums are reduced over the warp by
//   shuffles at the end, float32 FMAs on the CUDA cores.
//
// * pf_kernel, variant id "mma" (bfloat16 x, B > SMALL_BATCH_MAX, N a
//   multiple of 128, per-channel scales or groups of 128: every prefill
//   linear and every admission chunk). Work: M*N code bytes (M*N/2 packed)
//   and 2*B*M*N operations. At 64 rows it is bound by bytes (the bf16
//   tensor cores need ~295 operations a byte, a 64-row chunk gives 128 per
//   code byte); at 384 rows by operations. The PR 11 design (mma.sync from
//   an unpipelined 64 x 64 tile, one I2F per code, at most one CTA per SM
//   and no split of K; its times are kept in PERF.md) reached 1-11 % of
//   either bound. Here
//   - bytes: codes cross from device memory once, as int8 (or nibbles),
//     never widened in device memory; one producer lane keeps a ring of
//     3-4 stages of TMA copies (x tile and code tile, completion on an
//     mbarrier per stage) in flight ahead of the consumer, two CTAs an SM;
//   - filling the card: shapes with fewer output tiles than a wave of CTAs
//     split K by whole 128-column units (the wrapper's prefill_plan:
//     shapes, SM count and occupancy only; at most N / (2B) splits, so the
//     float32 partials stay under the code bytes, and at least two units
//     a split), the partials merged in ascending split order by tcgemv's
//     merge pass, a programmatic dependent launch: deterministic, no
//     atomics, capturable in a CUDA graph;
//   - operations: the products run on wgmma.mma_async m64n128k16 (bf16 in,
//     float32 accumulate). Layout: tokens are wgmma's M side and x is A,
//     read from shared memory as TMA wrote it (128-byte swizzle); the
//     consumer warpgroup widens the codes of a stage into a bf16 buffer
//     that is B (K-major, the same swizzle), exactly, by the byte-permute
//     arithmetic of widen_i8 / widen_i4_pair, while the tensor cores run
//     the stage before. Chosen over weights-as-A-from-registers ("swap
//     AB") because that puts the codes in the fragment's k order: x, which
//     TMA can only reorder in 16-byte pieces, would need a pass of its own
//     to match. Above 64 rows a CTA holds two m-tiles (128 tokens), so a
//     code is widened once per 128 tokens.
//   Measured on an H100 (PERF.md): the two big shapes at 64 rows take
//   0.44-0.51 of the bytes bound, faster than torch.matmul; the two small
//   ones pay ~5 us of launch, prologue and merge pass and stay ~10 %
//   slower; at 256-384 rows 0.3-0.45 of the operations bound: x is read
//   again for every 128 output rows and one warpgroup both widens and
//   issues the products.
//   The float32 instance (id "mma32", the same rule on shapes, scales and
//   alignment) takes one 64-token m-tile a CTA; TMA brings the x stage as
//   float32 in two 128-byte-swizzled boxes of 32 columns (16 KB a stage,
//   three stages, two CTAs an SM); the consumer reads its A fragments of
//   the stage from those boxes, splits them in registers into hi / mid /
//   lo and issues three wgmma m64n128k16 with A from registers (the RS
//   form: no bf16 copy of x in shared memory) on the one widened B buffer.
//   Its CTAs are ordered token tile first, so the CTAs that share a row
//   tile's codes run together and the codes cross from device memory once.
// * tiled_kernel (larger B, what the tensor-core instances do not take:
//   ragged N, other group sizes, misaligned x or codes; the first port's
//   body).
//   2*B*M*N multiply-adds on the CUDA cores in float32. A 64 x 64
//   output tile per block of 256 threads, a 4 x 4 micro-tile per thread, K
//   in steps of 32 through shared memory; codes are multiplied by their
//   scale while they are written to shared memory.
//
// Shapes that do not divide the tiles are masked, never refused.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// The small-batch variants (gemv_kernel, tcgemv_kernel) take B up to here;
// the wrapper's GEMV_MAX_BATCH is the same number.
constexpr int SMALL_BATCH_MAX = 16;

// Variant ids, as the wrapper's VARIANTS lists them.
enum Variant { GEMV = 0, TCGEMV = 1, MMA = 2, TILED = 3, TCGEMV32 = 4, MMA32 = 5 };

// The activation type of the tensor-core instances: bf16, or float32 (F32).
template <bool F32> struct Act { using T = __nv_bfloat16; };
template <> struct Act<true> { using T = float; };

template <bool BF16>
__device__ __forceinline__ float load_x(const void* x, long long i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

template <bool BF16>
__device__ __forceinline__ void store_y(void* y, long long i, float v) {
  if (BF16) static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(y)[i] = v;
}

// One code as an int, any column. Packed rows hold n/2 bytes.
template <bool PACKED>
__device__ __forceinline__ int load_code(const int8_t* crow, int col) {
  if (PACKED) {
    const int byte = (int)crow[col >> 1];          // sign-extended
    return (col & 1) ? (byte >> 4) : ((byte << 28) >> 28);
  }
  return (int)crow[col];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Two floats rounded to a bf16x2 word, the first in the low half.
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two float32 values (a low) split exactly into three bf16x2 words, a =
// hi.lo + mid.lo + lo.lo and b likewise in the high halves (see the head
// note: exact for |x| >= 2^-110 and zeros). A bf16 widens to float32 by a
// shift into the upper half; each remainder is an exact subtraction.
__device__ __forceinline__ void split_bf16x3(float a, float b, unsigned& hi,
                                             unsigned& mid, unsigned& lo) {
  hi = pack_bf16x2(a, b);
  const float ra = a - __uint_as_float(hi << 16);
  const float rb = b - __uint_as_float(hi & 0xFFFF0000u);
  mid = pack_bf16x2(ra, rb);
  lo = pack_bf16x2(ra - __uint_as_float(mid << 16),
                   rb - __uint_as_float(mid & 0xFFFF0000u));
}

// ---------------------------------------------------------------------------
// weight-streaming variant, B <= 16
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_RW = 2;                      // rows per warp
constexpr int GV_ROWS = GV_WARPS * GV_RW;     // rows per block

// KC columns of x are staged at a time: 1024 while that fits 32 KB of shared
// memory (NB <= 8), else 512.
template <int NB, int KC, bool PACKED, bool BF16>
__global__ void __launch_bounds__(GV_WARPS * 32)
gemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ codes,
            const float* __restrict__ scale, void* __restrict__ y,
            int b, int m, int n, int scols, int gs) {
  constexpr int STEPS = KC / 128;             // 128-column steps per chunk
  __shared__ __align__(16) float xs[NB][KC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * GV_ROWS + warp * GV_RW;
  const int b0 = blockIdx.y * NB;
  const long long rowbytes = PACKED ? (n >> 1) : n;
  // an aligned word per lane needs rows that start on a word, and a lane's
  // four columns inside one scale group
  const bool vec = (n % 4 == 0) && (scols == 1 || gs % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(codes) % 4 == 0);

  float acc[GV_RW][NB];
#pragma unroll
  for (int r = 0; r < GV_RW; ++r)
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[r][bb] = 0.f;

  for (int k0 = 0; k0 < n; k0 += KC) {
    // The chunk's code words and scales are requested first, so that their
    // trip to device memory overlaps the staging of x below.
    int wd[GV_RW][STEPS];
    float sc[GV_RW][STEPS];
    if (vec) {
#pragma unroll
      for (int r = 0; r < GV_RW; ++r) {
        const int row = row0 + r;
        const int8_t* crow = codes + (long long)row * rowbytes;
        const float* srow = scale + (long long)row * scols;
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
          const int col = k0 + j * 128 + lane * 4;
          wd[r][j] = 0;
          sc[r][j] = 0.f;
          if (row < m && col < n) {
            wd[r][j] = PACKED
                ? (int)*reinterpret_cast<const unsigned short*>(crow + (col >> 1))
                : *reinterpret_cast<const int*>(crow + col);
            sc[r][j] = srow[scols == 1 ? 0 : col / gs];
          }
        }
      }
    }

    __syncthreads();                   // the previous chunk has been consumed
    for (int i = threadIdx.x; i < NB * KC; i += GV_WARPS * 32) {
      const int bb = i / KC, c = i % KC;
      const int bi = b0 + bb, col = k0 + c;
      xs[bb][c] = (bi < b && col < n) ? load_x<BF16>(x, (long long)bi * n + col) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (k0 + j * 128 >= n) break;    // same in every thread
      const int c = j * 128 + lane * 4;
      const int col = k0 + c;
      float cw[GV_RW][4];              // codes (times the scale on the slow path)
      float sj[GV_RW];
#pragma unroll
      for (int r = 0; r < GV_RW; ++r) {
        if (vec) {
          const int v = wd[r][j];
          int c0, c1, c2, c3;
          if (PACKED) {                // low nibble = even column
            c0 = (v << 28) >> 28; c1 = (v << 24) >> 28;
            c2 = (v << 20) >> 28; c3 = (v << 16) >> 28;
          } else {
            c0 = (v << 24) >> 24; c1 = (v << 16) >> 24;
            c2 = (v << 8) >> 24;  c3 = v >> 24;
          }
          cw[r][0] = (float)c0; cw[r][1] = (float)c1;
          cw[r][2] = (float)c2; cw[r][3] = (float)c3;
          sj[r] = sc[r][j];
        } else {                       // any N, any group size: code by code
          const int row = row0 + r;
          sj[r] = 1.f;                 // scale folded into each code
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int cc = col + t;
            cw[r][t] = 0.f;
            if (row < m && cc < n)
              cw[r][t] = (float)load_code<PACKED>(
                             codes + (long long)row * rowbytes, cc) *
                         scale[(long long)row * scols + (scols == 1 ? 0 : cc / gs)];
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[bb][c]);
#pragma unroll
        for (int r = 0; r < GV_RW; ++r) {
          const float part = xv.x * cw[r][0] + xv.y * cw[r][1] +
                             xv.z * cw[r][2] + xv.w * cw[r][3];
          acc[r][bb] += sj[r] * part;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < GV_RW; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const float v = warp_sum(acc[r][bb]);
      if (lane == 0 && row < m && b0 + bb < b)
        store_y<BF16>(y, (long long)(b0 + bb) * m + row, v);
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory tiled variant, larger B
// ---------------------------------------------------------------------------

constexpr int TB = 64;     // batch rows per block
constexpr int TM = 64;     // output rows per block
constexpr int TK = 32;     // K step
constexpr int TS = 68;     // padded tile stride (keeps float4 alignment)

template <bool PACKED, bool BF16>
__global__ void __launch_bounds__(256)
tiled_kernel(const void* __restrict__ x, const int8_t* __restrict__ codes,
             const float* __restrict__ scale, void* __restrict__ y,
             int b, int m, int n, int scols, int gs) {
  __shared__ __align__(16) float xs[TK][TS];   // xs[k][batch row]
  __shared__ __align__(16) float ws[TK][TS];   // ws[k][output row], dequantized
  const int tx = threadIdx.x & 15;             // output rows 4*tx .. 4*tx+3
  const int ty = threadIdx.x >> 4;             // batch rows 4*ty .. 4*ty+3
  const int mt0 = blockIdx.x * TM;
  const int bt0 = blockIdx.y * TB;
  const long long rowbytes = PACKED ? (n >> 1) : n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += TK) {
    for (int i = threadIdx.x; i < TB * TK; i += 256) {
      const int r = i / TK, k = i % TK;
      const int bi = bt0 + r, col = k0 + k;
      xs[k][r] = (bi < b && col < n) ? load_x<BF16>(x, (long long)bi * n + col) : 0.f;
    }
    for (int i = threadIdx.x; i < TM * TK; i += 256) {
      const int r = i / TK, k = i % TK;
      const int row = mt0 + r, col = k0 + k;
      float v = 0.f;
      if (row < m && col < n)
        v = (float)load_code<PACKED>(codes + (long long)row * rowbytes, col) *
            scale[(long long)row * scols + (scols == 1 ? 0 : col / gs)];
      ws[k][r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bi = bt0 + ty * 4 + i;
    if (bi >= b) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = mt0 + tx * 4 + j;
      if (row < m) store_y<BF16>(y, (long long)bi * m + row, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core weight-streaming variant, bfloat16 x, B <= SMALL_BATCH_MAX
// ---------------------------------------------------------------------------

// mma.sync m16n8k16, bf16 in, float32 accumulate: d += a b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int TC_MT = 2;      // 16-row m-tiles per warp
constexpr int TC_NSTAGE = 6;  // ring stages: TC_NSTAGE - 1 k-ranges in flight
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = TC_WARPS * TC_MT * 16;   // output rows per CTA (the
                                                 // wrapper's TC_ROWS)
constexpr int TC_NR = 2 * TC_MT;                 // code rows of one lane

// KR: the columns of one k-range (a lane holds 16 code bytes of each of its
// rows: 16 int8 codes, or 32 nibbles); XV: 16-byte x vectors a lane copies
// per n-tile and k-range (twice as many for float32 x); MMAS: k16 steps per
// k-range.
template <bool PACKED, bool F32 = false> struct Tc {
  static constexpr int KR = PACKED ? 128 : 64;
  static constexpr int XV = (PACKED ? 4 : 2) * (F32 ? 2 : 1);
  static constexpr int MMAS = PACKED ? 8 : 4;
};

// 16-byte vectors a lane copies per stage: its code rows, then x.
template <int NT, bool PACKED, bool F32>
__host__ __device__ constexpr int tc_vecs() {
  return TC_NR + Tc<PACKED, F32>::XV * NT;
}

// Bytes of one ring stage of a CTA: every warp's vectors and its scales
// (TC_NR floats a lane).
template <int NT, bool PACKED, bool F32>
__host__ __device__ constexpr int tc_stage_bytes() {
  return TC_WARPS * 32 * (16 * tc_vecs<NT, PACKED, F32>() + 4 * TC_NR);
}

// The float32 instances' ring: TC_NSTAGE stages of the int8 one-n-tile
// instance (110 592 bytes, two CTAs an SM); the others take as many stages
// as fit it, at least 3.
constexpr int TC_F32_RING = TC_NSTAGE * tc_stage_bytes<1, false, true>();

template <int NT, bool PACKED, bool F32>
__host__ __device__ constexpr int tc_nstage() {
  return !F32 ? TC_NSTAGE
         : TC_F32_RING / tc_stage_bytes<NT, PACKED, F32>() < 3
             ? 3
             : TC_F32_RING / tc_stage_bytes<NT, PACKED, F32>();
}

// Dynamic shared memory of a CTA: every warp's ring of vectors, then every
// warp's ring of scales.
template <int NT, bool PACKED, bool F32>
__host__ __device__ constexpr int tc_smem_bytes() {
  return tc_nstage<NT, PACKED, F32>() * tc_stage_bytes<NT, PACKED, F32>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async into shared memory; ok == false reads nothing and zero-fills.
// Codes are read once: past L1, with the rest of the row's 128 bytes
// around them fetched into L2 for the next k-ranges.
__device__ __forceinline__ void cp16_stream(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// x and scales: cached in L1, where the CTA's other warps find them.
template <int BYTES>
__device__ __forceinline__ void cp_cached(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
               "r"(ok ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four int8 codes (one word, lowest byte first) to two bf16x2 words, lo =
// (c0, c1) and hi = (c2, c3), exactly and without I2F: the biased byte
// c + 128 becomes the low mantissa byte of 2^23 (0x4B0000xx), subtracting
// 2^23 + 128 leaves c in float32, and since |c| <= 128 fits 8 significant
// bits, the float's upper half is c in bfloat16.
__device__ __forceinline__ void widen_i8(unsigned w, unsigned& lo,
                                         unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  unsigned f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
        8388736.0f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// Two nibbles of a biased word u = w ^ 0x88888888 (each nibble c + 8) to one
// bf16x2 word, exactly: nibbles s (low half) and s + 4 (high half), i.e.
// columns s and s + 4 of the word's eight, go into the mantissa of 128
// (0x4300 | (c + 8) is 128 + c + 8), and one bf16x2 subtraction of 136
// leaves c.
__device__ __forceinline__ unsigned widen_i4_pair(unsigned u, int s) {
  const unsigned v = ((u >> (4 * s)) & 0x000F000Fu) | 0x43004300u;
  unsigned r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Grid (ceil(M / TC_ROWS), splits); TC_WARPS warps of TC_MT 16-row m-tiles
// each; NT n-tiles of 8 batch rows (B <= 8 * NT). Split s takes the scale
// groups [s*gps, s*gps + gps) and writes its float32 partial to
// part[s][B][M] (splits > 1) or y itself (splits == 1).
//
// The k16 steps of a k-range take the columns in a permuted order (the
// wrapper's tc_column_order states it): lane (gid, tig) holds columns
// tig*KR/4 .. tig*KR/4 + KR/4 - 1 of its rows gid and gid + 8. int8: step j
// takes columns 4j, 4j+1 (a0 / b0) and 4j+2, 4j+3 (a2 / b1) of those, so x
// needs no reordering; int4: step j takes columns (8i + s, 8i + s + 4) and
// (8i + s + 1, 8i + s + 5) with i = j / 2, s = 2 (j % 2), the pairs one
// mask of a nibble word gives, and x's pairs are formed to match by byte
// permutes (bf16) or picked from its float32 vectors 2i and 2i + 1 (F32).
// F32: x is float32 (and so is y); each B fragment is split into three
// (split_bf16x3) and the step issues three mma.sync, hi then mid then lo,
// on the same A fragment into the same accumulators.
template <int NT, bool PACKED, bool F32>
__global__ void __launch_bounds__(TC_THREADS)
tcgemv_kernel(const typename Act<F32>::T* __restrict__ x,
              const int8_t* __restrict__ codes,
              const float* __restrict__ scale,
              typename Act<F32>::T* __restrict__ y,
              float* __restrict__ part, int b, int m, int n, int scols,
              int gs, int gps) {
  using T = Tc<PACKED, F32>;
  using XT = typename Act<F32>::T;
  constexpr int V = tc_vecs<NT, PACKED, F32>();
  constexpr int NS = tc_nstage<NT, PACKED, F32>();
  constexpr int XPV = 16 / sizeof(XT);           // x elements a vector
  constexpr int PASSES = F32 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // let the merge pass's CTAs launch early; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * NS * V * 32 + lane;
  float* sring = reinterpret_cast<float*>(reinterpret_cast<uint4*>(smem) +
                                          TC_WARPS * NS * V * 32) +
                 (warp * NS * 32 + lane) * TC_NR;

  const int kpg = gs / T::KR;                    // k-ranges per group
  const int g0 = blockIdx.y * gps;
  const int nk = (min(n / gs, g0 + gps) - g0) * kpg;
  const int col0 = g0 * gs;
  const int wrow = blockIdx.x * TC_ROWS + warp * TC_MT * 16;
  const long long rowbytes = PACKED ? (n >> 1) : n;

  // lane's code rows: gid and gid + 8 of each m-tile; rows past M read
  // nothing and hold zeros
  const int8_t* crow[TC_NR];
  const float* srow[TC_NR];
  bool rok[TC_NR];
#pragma unroll
  for (int i = 0; i < TC_NR; ++i) {
    const int r = wrow + (i >> 1) * 16 + (i & 1) * 8 + gid;
    rok[i] = r < m;
    crow[i] = codes + (long long)(rok[i] ? r : 0) * rowbytes + tig * 16;
    srow[i] = scale + (long long)(rok[i] ? r : 0) * scols;
  }
  // lane's x rows: batch row gid of each n-tile (zeros past B)
  const XT* xrow[NT];
  bool xok[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int bi = t * 8 + gid;
    xok[t] = bi < b;
    xrow[t] = x + (long long)(xok[t] ? bi : 0) * n + tig * (T::KR / 4);
  }

  // copy k-range k of the split into stage k % NS (one commit group per
  // call, empty past the end, so the wait count stays fixed)
  auto issue = [&](int k) {
    if (k < nk) {
      uint4* slot = ring + (k % NS) * V * 32;
      const int col = col0 + k * T::KR;
      const long long cb = PACKED ? (col >> 1) : col;
#pragma unroll
      for (int i = 0; i < TC_NR; ++i)
        cp16_stream(slot + i * 32, crow[i] + cb, rok[i]);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int v = 0; v < T::XV; ++v)
          cp_cached<16>(slot + (TC_NR + t * T::XV + v) * 32,
                        xrow[t] + col + v * XPV, xok[t]);
      if (k % kpg == 0) {                        // a group starts: its scales
        const int g = scols == 1 ? 0 : col / gs;
        float* ss = sring + (k % NS) * 32 * TC_NR;
#pragma unroll
        for (int i = 0; i < TC_NR; ++i) cp_cached<4>(ss + i, srow[i] + g, rok[i]);
      }
    }
    cp_async_commit();
  };

  float tot[TC_MT][NT][4], grp[TC_MT][NT][4];
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][t][e] = grp[i][t][e] = 0.f;
  float sreg[TC_NR];
#pragma unroll
  for (int i = 0; i < TC_NR; ++i) sreg[i] = 0.f;

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) issue(k);
  for (int k = 0; k < nk; ++k) {
    issue(k + NS - 1);                 // the next loads before these products
    cp_async_wait<NS - 1>();           // k-range k has landed
    const int st = k % NS;
    const uint4* slot = ring + st * V * 32;
    const int kin = k % kpg;
    if (kin == 0) {
      const float* ss = sring + st * 32 * TC_NR;
#pragma unroll
      for (int i = 0; i < TC_NR; ++i) sreg[i] = ss[i];
    }
    uint4 cv[TC_NR];
#pragma unroll
    for (int i = 0; i < TC_NR; ++i) cv[i] = slot[i * 32];
    uint4 xv[NT][T::XV];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < T::XV; ++v) xv[t][v] = slot[(TC_NR + t * T::XV + v) * 32];

#pragma unroll
    for (int j = 0; j < T::MMAS; ++j) {
      unsigned bf[NT][PASSES][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if constexpr (F32) {
          // the float32 values behind b0 and b1, then their three parts
          float p[4];
          if (PACKED) {                // (x[s], x[s+4]) and (x[s+1], x[s+5])
            const uint4& A = xv[t][2 * (j >> 1)];
            const uint4& B = xv[t][2 * (j >> 1) + 1];
            const int s = 2 * (j & 1);
            p[0] = __uint_as_float(word(A, s));
            p[1] = __uint_as_float(word(B, s));
            p[2] = __uint_as_float(word(A, s + 1));
            p[3] = __uint_as_float(word(B, s + 1));
          } else {                     // (x[4j], x[4j+1]), (x[4j+2], x[4j+3])
            const uint4& X = xv[t][j];
            p[0] = __uint_as_float(X.x);
            p[1] = __uint_as_float(X.y);
            p[2] = __uint_as_float(X.z);
            p[3] = __uint_as_float(X.w);
          }
          split_bf16x3(p[0], p[1], bf[t][0][0], bf[t][1][0], bf[t][2][0]);
          split_bf16x3(p[2], p[3], bf[t][0][1], bf[t][1][1], bf[t][2][1]);
        } else {
          const uint4& X = xv[t][j >> 1];
          if (PACKED) {                // (x[s], x[s+4]) and (x[s+1], x[s+5])
            const unsigned lo = (j & 1) ? X.y : X.x;
            const unsigned hi = (j & 1) ? X.w : X.z;
            bf[t][0][0] = __byte_perm(lo, hi, 0x5410);
            bf[t][0][1] = __byte_perm(lo, hi, 0x7632);
          } else {                     // (x[4j], x[4j+1]), (x[4j+2], x[4j+3])
            bf[t][0][0] = (j & 1) ? X.z : X.x;
            bf[t][0][1] = (j & 1) ? X.w : X.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TC_MT; ++i) {
        unsigned a[4];
        if (PACKED) {
          const int s = 2 * (j & 1);
          const unsigned u0 = word(cv[2 * i], j >> 1) ^ 0x88888888u;
          const unsigned u1 = word(cv[2 * i + 1], j >> 1) ^ 0x88888888u;
          a[0] = widen_i4_pair(u0, s);
          a[2] = widen_i4_pair(u0, s + 1);
          a[1] = widen_i4_pair(u1, s);
          a[3] = widen_i4_pair(u1, s + 1);
        } else {
          widen_i8(word(cv[2 * i], j), a[0], a[2]);
          widen_i8(word(cv[2 * i + 1], j), a[1], a[3]);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int p = 0; p < PASSES; ++p) mma_bf16(grp[i][t], a, bf[t][p]);
      }
    }
    if (kin == kpg - 1) {              // the group ends: times its scale
#pragma unroll
      for (int i = 0; i < TC_MT; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][t][e] = fmaf(sreg[2 * i + (e >> 1)], grp[i][t][e],
                                tot[i][t][e]);
            grp[i][t][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  float* pp = part + (long long)blockIdx.y * b * m;
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + i * 16 + gid + (e >> 1) * 8;
        const int bi = t * 8 + tig * 2 + (e & 1);
        if (row < m && bi < b) {
          if (gridDim.y == 1)
            store_y<!F32>(y, (long long)bi * m + row, tot[i][t][e]);
          else
            pp[(long long)bi * m + row] = tot[i][t][e];
        }
      }
}

// The splits' partials added in ascending split order, one output a thread,
// into y of x's type (bf16, or float32 for the F32 instances). Launched as
// a programmatic dependent of the pass before it: it waits here for that
// grid's end.
template <bool BF16>
__global__ void __launch_bounds__(256)
tcgemv_merge(const float* __restrict__ part, void* __restrict__ y,
             int splits, long long bm) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= bm) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[s * bm + i];
  store_y<BF16>(y, i, v);
}

// ---------------------------------------------------------------------------
// prefill variant: wgmma on a TMA-fed ring, bfloat16 x, B > SMALL_BATCH_MAX
// ---------------------------------------------------------------------------
//
// CTA = one consumer warpgroup (warps 0-3) + one producer warp (warp 4).
// The CTA owns PF_BN output rows and MT m-tiles of PF_BM tokens, and walks
// its split's columns in stages of PF_BK. Per stage the producer's one
// lane asks TMA for the x tile (MT*64 tokens x 64 bf16, 128-byte swizzle,
// rows past B zero-filled) and the code tile (128 rows x 64 int8 codes or
// 32 bytes of nibbles, 64- or 32-byte swizzle, rows past M zero-filled)
// into a ring of pf_nstage<MT>() stages, with completion on the stage's
// `full` mbarrier; the consumer frees a stage on its `empty` mbarrier once
// the products that read it are done. Each consumer thread widens one code
// row of a stage (exact byte-permute arithmetic, no I2F) into one of two
// bf16 buffers laid out as wgmma's K-major, 128-byte-swizzled B operand,
// while the tensor cores run the previous stage's wgmma.mma_async
// m64n128k16 (A = the x tile, B = the widened codes, both from shared
// memory, float32 accumulators in registers; rows of D are tokens, columns
// output rows). The finished tile leaves through shared memory, 16 bytes a
// thread along output rows.
//
// Scales: per-channel (scols == 1), the split's float32 sum is multiplied
// by the row's scale once, at the end. Per-group (gs == PF_UNIT, MT == 1),
// each group's two stages accumulate into `acc` from zero, and the group's
// partial times its scale is added to `tot` in ascending group order.
//
// F32 (float32 x and y, MT == 1): the x stage is two float32 boxes of
// PF_X32_COLS columns; each consumer thread reads its A fragments of the
// stage's four k16 steps from them (8 bytes a load, the 128-byte swizzle
// undone in the address), splits them into hi / mid / lo (split_bf16x3)
// and, after one wgmma.fence, issues 3 x 4 wgmma m64n128k16 with A from
// registers on the stage's widened B buffer: per k16 step hi, mid, lo, in
// that order, into the one accumulator. Grid (token tiles, row tiles,
// splits): CTAs that read one row tile's codes are launched together.

constexpr int PF_BN = 128;        // output rows per CTA (wgmma N)
constexpr int PF_BM = 64;         // tokens per m-tile (wgmma M)
constexpr int PF_BK = 64;         // columns per ring stage (128 bytes of x)
constexpr int PF_UNIT = 128;      // columns of a split unit (= a scale group)
constexpr int PF_MT1_MAX_B = 64;  // up to here one m-tile per CTA, above it
                                  // two (per-channel scales only); the
                                  // wrapper's PF_MT1_MAX_B
constexpr int PF_WARPS = 5;
constexpr int PF_THREADS = PF_WARPS * 32;
constexpr int PF_B_BYTES = PF_BN * PF_BK * 2;      // one widened buffer
constexpr int PF_ST = PF_BN + 8;    // float row stride of the output tile
                                    // staged in shared memory (2-way banks)

// float32 x (the F32 instances, one m-tile): a stage's x is two TMA boxes
// of PF_X32_COLS columns (128 bytes, the swizzle's width) by PF_BM tokens,
// 16 KB, so the ring holds PF_X32_NSTAGE stages (two CTAs an SM)
constexpr int PF_X32_COLS = 32;
constexpr int PF_X32_BOX = PF_BM * PF_X32_COLS * 4;  // bytes of one box
constexpr int PF_X32_NSTAGE = 3;

template <int MT, bool F32 = false>
__host__ __device__ constexpr int pf_nstage() {
  return F32 ? PF_X32_NSTAGE : MT == 1 ? 4 : 3;
}
template <int MT, bool F32 = false>
__host__ __device__ constexpr int pf_x_bytes() {
  return MT * PF_BM * PF_BK * (F32 ? 4 : 2);
}
template <bool PACKED> __host__ __device__ constexpr int pf_c_bytes() {
  return PF_BN * PF_BK / (PACKED ? 2 : 1);
}
// ring stages, two widened buffers, 2 * NSTAGE mbarriers, and 1 KB of slack
// to align the base to the 128-byte swizzle's 1024-byte period
template <int MT, bool PACKED, bool F32 = false>
__host__ __device__ constexpr int pf_ring_bytes() {
  return pf_nstage<MT, F32>() *
         (pf_x_bytes<MT, F32>() + pf_c_bytes<PACKED>());
}
template <int MT, bool PACKED, bool F32 = false>
__host__ __device__ constexpr int pf_smem_bytes() {
  return 1024 + pf_ring_bytes<MT, PACKED, F32>() + 2 * PF_B_BYTES +
         16 * pf_nstage<MT, F32>();
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0),
         "r"(c1), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), start address in
// 16-byte units; a k16 step inside the swizzle atom adds 32 bytes.
__device__ __forceinline__ unsigned long long pf_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, float32 accumulate;
// acc == 0 overwrites D.
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          unsigned long long da,
                                          unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128] with A from registers (the
// warpgroup's fragment, laid out as mma.sync m16n8k16's A in each warp's 16
// rows), B from shared memory as in wgmma_128; acc == 0 overwrites D.
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64],
                                             const unsigned (&a)[4],
                                             unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The float32 A fragment of one k16 step for thread (warp, gid, tig) of the
// consumer warpgroup -- register q holds row 16*warp + gid + 8*(q & 1),
// columns 2*tig + 8*(q >> 1) and the next -- read from a stage's box of
// PF_X32_COLS columns (`half` selects the step's 16 of its 32) as TMA wrote
// it (16-byte chunk c of row r at chunk c ^ (r & 7)), then split into three
// bf16 fragments. A warp's loads meet no bank conflict beyond the two
// wavefronts that 256 bytes take.
__device__ __forceinline__ void pf_split_a(const unsigned char* box, int half,
                                           int warp, int gid, int tig,
                                           unsigned (&hi)[4],
                                           unsigned (&mid)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 16 * warp + gid + 8 * (q & 1);            // r & 7 == gid
    const int chunk = (4 * half + (tig >> 1) + 2 * (q >> 1)) ^ gid;
    const float2 v = *reinterpret_cast<const float2*>(
        box + r * 128 + chunk * 16 + (tig & 1) * 8);
    split_bf16x3(v.x, v.y, hi[q], mid[q], lo[q]);
  }
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// One code row of a stage (64 columns) widened to bf16 into row r of a
// widened buffer. Codes arrive with TMA's 64-byte (int8) or 32-byte
// (nibbles) swizzle: 16-byte chunk c of row r lies at chunk c ^ ((r >> 1) &
// 3), resp. c ^ ((r >> 2) & 1), so a warp's 32 rows read without bank
// conflicts; the widened row is written with the 128-byte swizzle wgmma
// reads (chunk c at c ^ (r & 7)).
template <bool PACKED>
__device__ __forceinline__ void pf_widen(const unsigned char* cs,
                                         unsigned char* bb, int r) {
  unsigned char* brow = bb + r * 128;
  if (!PACKED) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          cs + r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
      uint4 lo, hi;
      widen_i8(v.x, lo.x, lo.y);
      widen_i8(v.y, lo.z, lo.w);
      widen_i8(v.z, hi.x, hi.y);
      widen_i8(v.w, hi.z, hi.w);
      *reinterpret_cast<uint4*>(brow + (((2 * c) ^ (r & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(brow + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          cs + r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {       // 8 nibbles = columns 8wi..
        const unsigned u = word(v, wi) ^ 0x88888888u;
        const unsigned p0 = widen_i4_pair(u, 0), p1 = widen_i4_pair(u, 1);
        const unsigned p2 = widen_i4_pair(u, 2), p3 = widen_i4_pair(u, 3);
        const uint4 o = make_uint4(__byte_perm(p0, p1, 0x5410),
                                   __byte_perm(p2, p3, 0x5410),
                                   __byte_perm(p0, p1, 0x7632),
                                   __byte_perm(p2, p3, 0x7632));
        *reinterpret_cast<uint4*>(brow + (((4 * c + wi) ^ (r & 7)) << 4)) = o;
      }
    }
  }
}

// Grid (ceil(M / PF_BN), ceil(B / (MT * PF_BM)), splits); F32: (ceil(B /
// PF_BM), ceil(M / PF_BN), splits). Split s takes the PF_UNIT-column units
// [s*ups, s*ups + ups) and writes its float32 partial to part[s][B][M]
// (splits > 1) or y itself (splits == 1).
template <int MT, bool PACKED, bool GROUPED, bool F32>
__global__ void __launch_bounds__(PF_THREADS, GROUPED ? 1 : 2)
pf_kernel(const __grid_constant__ CUtensorMap tmx,
          const __grid_constant__ CUtensorMap tmc,
          const float* __restrict__ scale,
          typename Act<F32>::T* __restrict__ y,
          float* __restrict__ part, int b, int m, int n, int scols, int ups) {
  static_assert(!GROUPED || MT == 1, "per-group scales take one m-tile");
  static_assert(!F32 || MT == 1, "float32 x takes one m-tile");
  static_assert(MT * PF_BM * PF_ST * 4 <=
                    pf_ring_bytes<MT, PACKED, F32>() + 2 * PF_B_BYTES,
                "the output tile is staged in the drained ring and buffers");
  constexpr int NS = pf_nstage<MT, F32>();
  constexpr int XB = pf_x_bytes<MT, F32>();
  constexpr int CB = pf_c_bytes<PACKED>();
  constexpr int KPU = PF_UNIT / PF_BK;           // stages per unit
  extern __shared__ __align__(16) unsigned char smem[];
  // let the merge pass's CTAs launch early; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const unsigned raw = smem_addr(smem);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const unsigned xs0 = base, cs0 = xs0 + NS * XB, bb0 = cs0 + NS * CB;
  const unsigned bar0 = bb0 + 2 * PF_B_BYTES;   // full[s], empty[s]
  const int units = n / PF_UNIT;
  const int u0 = blockIdx.z * ups;
  const int nk = (min(units, u0 + ups) - u0) * KPU;
  const int col0 = u0 * PF_UNIT;
  const int row0 = (F32 ? blockIdx.y : blockIdx.x) * PF_BN;   // first row
  const int tok0 = (F32 ? blockIdx.x : blockIdx.y) * MT * PF_BM;  // token

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2 * NS; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                      // the producer warp
    if (threadIdx.x == 128) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(
          reinterpret_cast<unsigned long long>(&tmx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(
          reinterpret_cast<unsigned long long>(&tmc)) : "memory");
      for (int k = 0; k < nk; ++k) {
        const int s = k % NS;
        if (k >= NS) mbar_wait(bar0 + 8 * (NS + s), ((k / NS) & 1) ^ 1);
        mbar_expect_tx(bar0 + 8 * s, XB + CB);
        const int col = col0 + k * PF_BK;
        tma_load_2d(xs0 + s * XB, &tmx, col, tok0, bar0 + 8 * s);
        if constexpr (F32)
          tma_load_2d(xs0 + s * XB + PF_X32_BOX, &tmx, col + PF_X32_COLS,
                      tok0, bar0 + 8 * s);
        tma_load_2d(cs0 + s * CB, &tmc, PACKED ? col >> 1 : col, row0,
                    bar0 + 8 * s);
      }
    }
    return;
  }

  // the consumer warpgroup: thread t widens code row t of each stage and
  // holds the D fragments of rows 16*warp + gid (+8) of each m-tile,
  // columns 8j + 2*tig (+1)
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[MT][64];
  float tot[GROUPED ? 64 : 1];
  float sreg[32];                                // scales of columns 8j+2tig+e
  auto load_scales = [&](int g) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * j + 2 * tig + e;
        sreg[2 * j + e] = r < m ? __ldg(scale + (long long)r * scols + g) : 0.f;
      }
  };
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  }

  auto widen_stage = [&](int k) {
    const int s = k % NS;
    mbar_wait(bar0 + 8 * s, (k / NS) & 1);
    pf_widen<PACKED>(gbase + (cs0 - base) + s * CB,
                     gbase + (bb0 - base) + (k & 1) * PF_B_BYTES, t);
    // the widened rows are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  widen_stage(0);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  for (int k = 0; k < nk; ++k) {
    const int s = k % NS;
    const bool first = GROUPED ? (k % KPU == 0) : (k == 0);
    if (GROUPED && k % KPU == 0) load_scales((col0 + k * PF_BK) / PF_UNIT);
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    if constexpr (F32) {
      // every A fragment of the stage split before the products, so that no
      // register a wgmma reads is written while the group runs
      unsigned a3[PF_BK / 16][3][4];
      const unsigned char* xs = gbase + (xs0 - base) + s * XB;
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk)
        pf_split_a(xs + (kk >> 1) * PF_X32_BOX, kk & 1, warp, gid, tig,
                   a3[kk][0], a3[kk][1], a3[kk][2]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < 3; ++p)             // hi, mid, lo
          wgmma_128_rs(acc[0], a3[kk][p],
                       pf_desc(bb0 + (k & 1) * PF_B_BYTES + kk * 32),
                       (first && kk == 0 && p == 0) ? 0 : 1);
    } else {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          wgmma_128(acc[i], pf_desc(xs0 + s * XB + i * PF_BM * 128 + kk * 32),
                    pf_desc(bb0 + (k & 1) * PF_B_BYTES + kk * 32),
                    (first && kk == 0) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (k + 1 < nk) widen_stage(k + 1);         // overlaps the products
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    if constexpr (GROUPED) {
      if (k % KPU == KPU - 1) {                  // the group ends
#pragma unroll
        for (int i = 0; i < 64; ++i)
          tot[i] = fmaf(sreg[2 * (i >> 2) + (i & 1)], acc[0][i], tot[i]);
      }
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (t == 0) mbar_arrive(bar0 + 8 * (NS + s));   // stage s is free
  }

  // The tile goes out through shared memory (the ring and the widened
  // buffers are drained: every stage and product was waited for), so that
  // global stores are 16 bytes a thread along output rows instead of the
  // fragments' scattered 4 bytes.
  if constexpr (!GROUPED) load_scales(0);   // per-channel: once, after the sum
  float* st = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < 32; ++q) {               // registers 2q, 2q + 1
      const int tl = i * PF_BM + 16 * warp + gid + 8 * (q & 1);
      const int j = 2 * (q >> 1);
      float2 v;
      if constexpr (GROUPED) {
        v = make_float2(tot[2 * q], tot[2 * q + 1]);
      } else {
        v = make_float2(acc[i][2 * q] * sreg[j], acc[i][2 * q + 1] * sreg[j + 1]);
      }
      *reinterpret_cast<float2*>(st + tl * PF_ST + 4 * j + 2 * tig) = v;
    }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  float* pp = part + (long long)blockIdx.z * b * m;
  // 16-byte stores: 8 bf16 outputs, or 4 float32 (partials; F32's y)
  const bool vec = gridDim.z == 1 && !F32 ? m % 8 == 0 : m % 4 == 0;
  for (int e = t; e < MT * PF_BM * (PF_BN / 8); e += 128) {
    const int tl = e / (PF_BN / 8), c8 = (e % (PF_BN / 8)) * 8;
    const int tok = tok0 + tl, row = row0 + c8;
    if (tok >= b || row >= m) continue;
    const float4 lo = *reinterpret_cast<const float4*>(st + tl * PF_ST + c8);
    const float4 hi = *reinterpret_cast<const float4*>(st + tl * PF_ST + c8 + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long o = (long long)tok * m + row;
    if (vec && row + 8 <= m) {
      if constexpr (F32) {
        float* out = gridDim.z == 1 ? y : pp;
        *reinterpret_cast<float4*>(out + o) = lo;
        *reinterpret_cast<float4*>(out + o + 4) = hi;
      } else if (gridDim.z == 1) {
        uint4 w;
        w.x = pack_bf16x2(v[0], v[1]);
        w.y = pack_bf16x2(v[2], v[3]);
        w.z = pack_bf16x2(v[4], v[5]);
        w.w = pack_bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(y + o) = w;
      } else {
        *reinterpret_cast<float4*>(pp + o) = lo;
        *reinterpret_cast<float4*>(pp + o + 4) = hi;
      }
    } else {
      for (int c = 0; c < 8 && row + c < m; ++c) {
        if (gridDim.z == 1) store_y<!F32>(y, o + c, v[c]);
        else pp[o + c] = v[c];
      }
    }
  }
}

template <bool PACKED, bool BF16>
void launch_gemv(const void* x, const int8_t* codes, const float* scale, void* y,
                 int b, int m, int n, int scols, int gs, cudaStream_t st) {
  const dim3 block(GV_WARPS * 32);
  const unsigned gx = (unsigned)((m + GV_ROWS - 1) / GV_ROWS);
#define GV_CASE(NB, KC)                                                      \
  gemv_kernel<NB, KC, PACKED, BF16>                                          \
      <<<dim3(gx, (unsigned)((b + NB - 1) / NB)), block, 0, st>>>(           \
          x, codes, scale, y, b, m, n, scols, gs)
  if (b <= 1) GV_CASE(1, 1024);
  else if (b <= 2) GV_CASE(2, 1024);
  else if (b <= 4) GV_CASE(4, 1024);
  else if (b <= 8) GV_CASE(8, 1024);
  else GV_CASE(16, 512);
#undef GV_CASE
}

struct Args {
  const void *x, *codes;
  const float* scale;
  void* y;
  float* part;
  int b, m, n, scols, gs, splits, gps;
  cudaStream_t st;
};

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      p = nullptr;
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 2-D tensor map of `rows` rows of `cols` elements (row stride `cols`),
// read in boxes of box_rows x box_cols; boxes past the edge are zero-filled.
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt,
                int esz, long long cols, long long rows, int box_cols,
                int box_rows, CUtensorMapSwizzle swz) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * esz)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// A pass of 256-thread blocks over `count` outputs, launched on `st` as a
// programmatic dependent of the pass before it (a merge pass).
template <typename Kernel, typename... Ts>
int launch_dependent(Kernel kern, long long count, cudaStream_t st,
                     Ts... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((count + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


// Launch tcgemv's instance for NT n-tiles (float32 x: F32), or (occ given)
// only report how many of its CTAs an SM holds at once.
template <int NT, bool PACKED, bool F32>
int launch_tc(const Args& a, int* occ) {
  using XT = typename Act<F32>::T;
  auto kern = tcgemv_kernel<NT, PACKED, F32>;
  constexpr int smem = tc_smem_bytes<NT, PACKED, F32>();
  // the shared-memory limit is an attribute of the function on a device:
  // set once per device, not per launch
  static std::atomic<unsigned long long> ready{0};
  const int ae = smem_attr_once(kern, smem, ready);
  if (ae != 0) return ae;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kern, TC_THREADS, smem);
  const dim3 grid((unsigned)((a.m + TC_ROWS - 1) / TC_ROWS), (unsigned)a.splits);
  kern<<<grid, TC_THREADS, smem, a.st>>>(
      static_cast<const XT*>(a.x), static_cast<const int8_t*>(a.codes),
      a.scale, static_cast<XT*>(a.y), a.part, a.b, a.m, a.n, a.scols, a.gs,
      a.gps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long bm = (long long)a.b * a.m;
  return launch_dependent(tcgemv_merge<!F32>, bm, a.st, (const float*)a.part,
                          a.y, a.splits, bm);
}

template <bool PACKED, bool F32>
int launch_tc_nt(const Args& a, int* occ) {
  if (a.b <= 8) return launch_tc<1, PACKED, F32>(a, occ);
  return launch_tc<2, PACKED, F32>(a, occ);
}

// m-tiles of the bf16 prefill CTA: the wrapper's prefill_tile_rows states
// the same rule (the float32 instance always takes one)
int pf_mt(int b, int scols) { return scols == 1 && b > PF_MT1_MAX_B ? 2 : 1; }

// Launch the prefill instance (MT, PACKED, GROUPED, F32), or (occ given)
// only report how many of its CTAs an SM holds at once.
template <int MT, bool PACKED, bool GROUPED, bool F32>
int launch_pf(const Args& a, int* occ) {
  auto kern = pf_kernel<MT, PACKED, GROUPED, F32>;
  constexpr int smem = pf_smem_bytes<MT, PACKED, F32>();
  static std::atomic<unsigned long long> ready{0};
  const int e = smem_attr_once(kern, smem, ready);
  if (e != 0) return e;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kern, PF_THREADS, smem);
  CUtensorMap tmx, tmc;
  const long long rowbytes = PACKED ? a.n / 2 : a.n;
  const unsigned rtiles = (unsigned)((a.m + PF_BN - 1) / PF_BN);
  const unsigned ttiles = (unsigned)((a.b + MT * PF_BM - 1) / (MT * PF_BM));
  if ((F32 ? rtiles : ttiles) > 65535u) return (int)cudaErrorInvalidValue;
  if (!tensor_map(&tmx, a.x, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  F32 ? 4 : 2, a.n, a.b, F32 ? PF_X32_COLS : PF_BK, MT * PF_BM,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmc, a.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rowbytes,
                  a.m, PACKED ? PF_BK / 2 : PF_BK, PF_BN,
                  PACKED ? CU_TENSOR_MAP_SWIZZLE_32B
                         : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(F32 ? ttiles : rtiles, F32 ? rtiles : ttiles,
                  (unsigned)a.splits);
  kern<<<grid, PF_THREADS, smem, a.st>>>(
      tmx, tmc, a.scale, static_cast<typename Act<F32>::T*>(a.y), a.part,
      a.b, a.m, a.n, a.scols, a.gps);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess || a.splits == 1) return (int)le;
  const long long bm = (long long)a.b * a.m;
  return launch_dependent(tcgemv_merge<!F32>, bm, a.st, (const float*)a.part,
                          a.y, a.splits, bm);
}

template <bool PACKED, bool F32>
int launch_pf_mt(const Args& a, int* occ) {
  if (a.scols != 1) return launch_pf<1, PACKED, true, F32>(a, occ);
  if (!F32 && pf_mt(a.b, a.scols) == 2)
    return launch_pf<2, PACKED, false, false>(a, occ);
  return launch_pf<1, PACKED, false, F32>(a, occ);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool PACKED, bool BF16>
int launch(const Args& a, int variant) {
  const int ng = a.n / a.gs;
  switch (variant) {
    case GEMV:
      if (a.b > SMALL_BATCH_MAX) return (int)cudaErrorInvalidValue;
      launch_gemv<PACKED, BF16>(a.x, static_cast<const int8_t*>(a.codes),
                                a.scale, a.y, a.b, a.m, a.n, a.scols, a.gs,
                                a.st);
      return (int)cudaGetLastError();
    case TCGEMV:
    case TCGEMV32:          // the bf16 instance, or the float32 one
      if ((variant == TCGEMV) != BF16 || a.b > SMALL_BATCH_MAX ||
          a.gs % Tc<PACKED>::KR != 0 ||
          a.n % a.gs != 0 || !aligned16(a.x) || !aligned16(a.codes) ||
          a.splits < 1 || a.gps < 1 || (long long)a.splits * a.gps < ng ||
          (long long)(a.splits - 1) * a.gps >= ng ||
          (a.splits > 1 && a.part == nullptr))
        return (int)cudaErrorInvalidValue;
      return launch_tc_nt<PACKED, !BF16>(a, nullptr);
    case MMA:
    case MMA32:
      if ((variant == MMA) != BF16 || a.n % PF_UNIT != 0 ||
          (a.scols != 1 && a.gs != PF_UNIT) ||
          !aligned16(a.x) || !aligned16(a.codes) || a.splits < 1 ||
          a.gps < 1 || (long long)a.splits * a.gps < a.n / PF_UNIT ||
          (long long)(a.splits - 1) * a.gps >= a.n / PF_UNIT ||
          (a.splits > 1 && a.part == nullptr))
        return (int)cudaErrorInvalidValue;
      return launch_pf_mt<PACKED, !BF16>(a, nullptr);
    case TILED: {
      const dim3 grid((unsigned)((a.m + TM - 1) / TM),
                      (unsigned)((a.b + TB - 1) / TB));
      tiled_kernel<PACKED, BF16><<<grid, 256, 0, a.st>>>(
          a.x, static_cast<const int8_t*>(a.codes), a.scale, a.y, a.b, a.m,
          a.n, a.scols, a.gs);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y[B, M] = x[B, N] @ (codes * scale)^T through the variant the wrapper
// chose (0 gemv, 1 tcgemv, 2 mma, 3 tiled, 4 tcgemv32, 5 mma32). `scols`
// is 1 (per-channel scales) or n / gs (per-group); `packed` says two 4-bit
// codes per byte; `bf16` says x and y are bfloat16 (else float32: tcgemv32
// and mma32 take only float32, tcgemv and mma only bfloat16). tcgemv(32):
// `splits` CTAs per row tile of `gps` scale groups each (splits * gps >=
// n / gs > (splits - 1) * gps), `part` float32 scratch of splits * B * M
// (unused, may be null, when splits == 1). Launches on `stream`, allocates
// nothing, does not synchronise. Returns the CUDA error of the launches (0:
// ok); cudaErrorInvalidValue when the variant cannot take the shape.
// mma(32): `splits` CTAs per output tile of `gps` 128-column units each
// (the same cover rule over n / 128 units), `part` as for tcgemv.
int dequant_matmul_launch(const void* x, const void* codes, const void* scale,
                          void* y, void* part, int b, int m, int n, int scols,
                          int gs, int packed, int bf16, int variant,
                          int splits, int gps, void* stream) {
  const Args a{x, codes, static_cast<const float*>(scale), y,
               static_cast<float*>(part), b, m, n, scols, gs, splits, gps,
               reinterpret_cast<cudaStream_t>(stream)};
  if (packed) {
    if (bf16) return launch<true, true>(a, variant);
    return launch<true, false>(a, variant);
  }
  if (bf16) return launch<false, true>(a, variant);
  return launch<false, false>(a, variant);
}

// How many CTAs of tcgemv's instance for (packed, batch b, float32 x) an SM
// holds at once, into *out; the wrapper's split plan aims at a wave of them.
int dequant_matmul_tc_ctas_per_sm(int packed, int b, int f32, int* out) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, b, 1, 1, 1, 1,
               1, 1, nullptr};
  if (f32)
    return packed ? launch_tc_nt<true, true>(a, out)
                  : launch_tc_nt<false, true>(a, out);
  return packed ? launch_tc_nt<true, false>(a, out)
                : launch_tc_nt<false, false>(a, out);
}

// How many CTAs of the prefill instance for (packed, batch b, scols,
// float32 x) an SM holds at once, into *out; the wrapper's prefill plan
// aims at a wave.
int dequant_matmul_pf_ctas_per_sm(int packed, int b, int scols, int f32,
                                  int* out) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, b, 1, 1, scols,
               1, 1, 1, nullptr};
  if (f32)
    return packed ? launch_pf_mt<true, true>(a, out)
                  : launch_pf_mt<false, true>(a, out);
  return packed ? launch_pf_mt<true, false>(a, out)
                : launch_pf_mt<false, false>(a, out);
}

}  // extern "C"
