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
// Four variants behind one entry point. Which one takes a launch is decided
// by one rule on shapes, types and alignment, stated once in the wrapper
// (repro_torch/kernels/dequant_matmul.py: variant) and passed in as
// `variant`; each variant here refuses (cudaErrorInvalidValue) a launch it
// cannot take, it never picks another.
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
//
// * gemv_kernel (float32 x, or bfloat16 x that tcgemv does not take;
//   B <= SMALL_BATCH_MAX). CUDA cores, float32 throughout: a block of 8
//   warps owns 16 output rows, stages up to 1024 columns of x for all its
//   batch rows in shared memory, and each lane reads one aligned 32-bit word
//   of codes (16 bits when packed) per 128-column step. All of a chunk's
//   code words are requested before x is staged. A 128-column step lies
//   inside one scale group, so the scale multiplies the lane's partial dot
//   product once per step. Partial sums are reduced over the warp by
//   shuffles at the end. float32 x is never rounded to bf16 or TF32.
//
// * mma_kernel (larger B, bfloat16 x, N a multiple of 128: the prefill).
//   Bound by operations: 2*B*M*N multiply-adds. They go to the tensor cores
//   through mma.sync (bf16 in, float32 accumulate) from a 64 x 64 x 128 tile
//   in shared memory; see the note above the kernel. No pipelining yet: the
//   loads of a tile and its products take turns.
//
// * tiled_kernel (larger B, everything else: float32 x, ragged N or group
//   sizes). 2*B*M*N multiply-adds on the CUDA cores in float32. A 64 x 64
//   output tile per block of 256 threads, a 4 x 4 micro-tile per thread, K
//   in steps of 32 through shared memory; codes are multiplied by their
//   scale while they are written to shared memory.
//
// Shapes that do not divide the tiles are masked, never refused.

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
enum Variant { GEMV = 0, TCGEMV = 1, MMA = 2, TILED = 3 };

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
// tensor-core variant for bfloat16 x, larger B, N a multiple of 128
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16 (bf16 x bf16 -> f32): A = a 16 x 16 piece of x, B = 8
// output rows x 16 columns of codes widened to bf16 (exact: |code| <= 127),
// D = 16 batch rows x 8 output rows. A block of 4 warps owns 64 batch rows x
// 64 output rows and walks K in tiles of 128 columns = one scale group, so
// each tile's sum is multiplied by its (output row, group) scale AFTER the
// dot, in float32, as the reference kernel does. Tiles pass through shared
// memory with rows padded to 136 elements, which spreads a fragment's eight
// rows over all 32 banks.

constexpr int MB = 64;      // batch rows per block
constexpr int MM = 64;      // output rows per block
constexpr int MK = 128;     // K tile = scale group
constexpr int MS = 136;     // padded row stride in shared memory (bf16 elements)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool PACKED>
__global__ void __launch_bounds__(128)
mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
           int b, int m, int n, int scols) {
  __shared__ __align__(16) __nv_bfloat16 xs[MB][MS];
  __shared__ __align__(16) __nv_bfloat16 ws[MM][MS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;      // fragment coordinates
  const int wb = (warp >> 1) * 32;                // warp's batch rows in the tile
  const int wm = (warp & 1) * 32;                 // warp's output rows in the tile
  const int mt0 = blockIdx.x * MM, bt0 = blockIdx.y * MB;
  const long long rowbytes = PACKED ? (n >> 1) : n;

  float tot[2][4][4], grp[2][4][4];               // [batch 16-block][row 8-block][frag]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += MK) {
    // x tile: 64 rows x 128 bf16 = 1024 vectors of 8
    for (int v = tid; v < MB * (MK / 8); v += 128) {
      const int r = v / (MK / 8), c8 = (v % (MK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (bt0 + r < b)
        val = *reinterpret_cast<const uint4*>(x + (long long)(bt0 + r) * n + k0 + c8);
      *reinterpret_cast<uint4*>(&xs[r][c8]) = val;
    }
    // code tile: 64 rows x 128 codes, 16 bytes at a time, widened to bf16
    constexpr int CPV = PACKED ? 32 : 16;         // codes per 16-byte vector
    for (int v = tid; v < MM * (MK / CPV); v += 128) {
      const int r = v / (MK / CPV), c0 = (v % (MK / CPV)) * CPV;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (mt0 + r < m)
        val = *reinterpret_cast<const uint4*>(
            codes + (long long)(mt0 + r) * rowbytes + ((k0 + c0) >> (PACKED ? 1 : 0)));
      const unsigned words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const int wv = (int)words[wi];
        if (PACKED) {                             // 8 codes, low nibble first
#pragma unroll
          for (int t = 0; t < 8; ++t)
            ws[r][c0 + wi * 8 + t] =
                __int2bfloat16_rn((wv << (28 - 4 * t)) >> 28);
        } else {                                  // 4 codes
#pragma unroll
          for (int t = 0; t < 4; ++t)
            ws[r][c0 + wi * 4 + t] =
                __int2bfloat16_rn((wv << (24 - 8 * t)) >> 24);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) grp[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MK; kk += 16) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wb + i * 16 + gid;
        af[i][0] = *reinterpret_cast<const unsigned*>(&xs[r][kk + tig * 2]);
        af[i][1] = *reinterpret_cast<const unsigned*>(&xs[r + 8][kk + tig * 2]);
        af[i][2] = *reinterpret_cast<const unsigned*>(&xs[r][kk + tig * 2 + 8]);
        af[i][3] = *reinterpret_cast<const unsigned*>(&xs[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wm + j * 8 + gid;
        bf[j][0] = *reinterpret_cast<const unsigned*>(&ws[r][kk + tig * 2]);
        bf[j][1] = *reinterpret_cast<const unsigned*>(&ws[r][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(grp[i][j], af[i], bf[j]);
    }
    // this tile's scale, per output row: fragment columns tig*2 and tig*2+1
    const int sidx = scols == 1 ? 0 : k0 / MK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = mt0 + wm + j * 8 + tig * 2;
      const float s0 = row < m ? scale[(long long)row * scols + sidx] : 0.f;
      const float s1 = row + 1 < m ? scale[(long long)(row + 1) * scols + sidx] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tot[i][j][0] += s0 * grp[i][j][0];
        tot[i][j][1] += s1 * grp[i][j][1];
        tot[i][j][2] += s0 * grp[i][j][2];
        tot[i][j][3] += s1 * grp[i][j][3];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bi = bt0 + wb + i * 16 + gid + (e >> 1) * 8;
        const int row = mt0 + wm + j * 8 + tig * 2 + (e & 1);
        if (bi < b && row < m)
          y[(long long)bi * m + row] = __float2bfloat16_rn(tot[i][j][e]);
      }
}

// ---------------------------------------------------------------------------
// tensor-core weight-streaming variant, bfloat16 x, B <= SMALL_BATCH_MAX
// ---------------------------------------------------------------------------

constexpr int TC_MT = 2;      // 16-row m-tiles per warp
constexpr int TC_NSTAGE = 6;  // ring stages: TC_NSTAGE - 1 k-ranges in flight
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = TC_WARPS * TC_MT * 16;   // output rows per CTA (the
                                                 // wrapper's TC_ROWS)
constexpr int TC_NR = 2 * TC_MT;                 // code rows of one lane

// KR: the columns of one k-range (a lane holds 16 code bytes of each of its
// rows: 16 int8 codes, or 32 nibbles); XV: 16-byte x vectors a lane copies
// per n-tile and k-range; MMAS: k16 steps per k-range.
template <bool PACKED> struct Tc {
  static constexpr int KR = PACKED ? 128 : 64;
  static constexpr int XV = PACKED ? 4 : 2;
  static constexpr int MMAS = PACKED ? 8 : 4;
};

// 16-byte vectors a lane copies per stage: its code rows, then x.
template <int NT, bool PACKED>
__host__ __device__ constexpr int tc_vecs() { return TC_NR + Tc<PACKED>::XV * NT; }

// Dynamic shared memory of a CTA: every warp's ring of vectors, then every
// warp's ring of scales (TC_NR floats a lane and stage).
template <int NT, bool PACKED>
__host__ __device__ constexpr int tc_smem_bytes() {
  return TC_WARPS * TC_NSTAGE * 32 * (16 * tc_vecs<NT, PACKED>() + 4 * TC_NR);
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
// permutes.
template <int NT, bool PACKED>
__global__ void __launch_bounds__(TC_THREADS)
tcgemv_kernel(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ codes,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
              float* __restrict__ part, int b, int m, int n, int scols,
              int gs, int gps) {
  using T = Tc<PACKED>;
  constexpr int V = tc_vecs<NT, PACKED>();
  extern __shared__ __align__(16) unsigned char smem[];
  // let the merge pass's CTAs launch early; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * TC_NSTAGE * V * 32 +
                lane;
  float* sring = reinterpret_cast<float*>(reinterpret_cast<uint4*>(smem) +
                                          TC_WARPS * TC_NSTAGE * V * 32) +
                 (warp * TC_NSTAGE * 32 + lane) * TC_NR;

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
  const __nv_bfloat16* xrow[NT];
  bool xok[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int bi = t * 8 + gid;
    xok[t] = bi < b;
    xrow[t] = x + (long long)(xok[t] ? bi : 0) * n + tig * (T::KR / 4);
  }

  // copy k-range k of the split into stage k % TC_NSTAGE (one commit group
  // per call, empty past the end, so the wait count stays fixed)
  auto issue = [&](int k) {
    if (k < nk) {
      uint4* slot = ring + (k % TC_NSTAGE) * V * 32;
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
                        xrow[t] + col + v * 8, xok[t]);
      if (k % kpg == 0) {                        // a group starts: its scales
        const int g = scols == 1 ? 0 : col / gs;
        float* ss = sring + (k % TC_NSTAGE) * 32 * TC_NR;
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
  for (int k = 0; k < TC_NSTAGE - 1; ++k) issue(k);
  for (int k = 0; k < nk; ++k) {
    issue(k + TC_NSTAGE - 1);          // the next loads before these products
    cp_async_wait<TC_NSTAGE - 1>();    // k-range k has landed
    const int st = k % TC_NSTAGE;
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
      unsigned bf[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint4& X = xv[t][j >> 1];
        if (PACKED) {                  // (x[s], x[s+4]) and (x[s+1], x[s+5])
          const unsigned lo = (j & 1) ? X.y : X.x;
          const unsigned hi = (j & 1) ? X.w : X.z;
          bf[t][0] = __byte_perm(lo, hi, 0x5410);
          bf[t][1] = __byte_perm(lo, hi, 0x7632);
        } else {                       // (x[4j], x[4j+1]), (x[4j+2], x[4j+3])
          bf[t][0] = (j & 1) ? X.z : X.x;
          bf[t][1] = (j & 1) ? X.w : X.y;
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
        for (int t = 0; t < NT; ++t) mma_bf16(grp[i][t], a, bf[t]);
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
            y[(long long)bi * m + row] = __float2bfloat16_rn(tot[i][t][e]);
          else
            pp[(long long)bi * m + row] = tot[i][t][e];
        }
      }
}

// The splits' partials added in ascending split order, one output a thread.
// Launched as a programmatic dependent of tcgemv_kernel: it waits here for
// that grid's end.
__global__ void __launch_bounds__(256)
tcgemv_merge(const float* __restrict__ part, __nv_bfloat16* __restrict__ y,
             int splits, long long bm) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= bm) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[s * bm + i];
  y[i] = __float2bfloat16_rn(v);
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

// Launch tcgemv's instance for NT n-tiles, or (occ given) only report how
// many of its CTAs an SM holds at once.
template <int NT, bool PACKED>
int launch_tc(const Args& a, int* occ) {
  auto kern = tcgemv_kernel<NT, PACKED>;
  constexpr int smem = tc_smem_bytes<NT, PACKED>();
  // the shared-memory limit is an attribute of the function on a device:
  // set once per device, not per launch (a race sets it twice, harmlessly)
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kern, TC_THREADS, smem);
  const dim3 grid((unsigned)((a.m + TC_ROWS - 1) / TC_ROWS), (unsigned)a.splits);
  kern<<<grid, TC_THREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const int8_t*>(a.codes), a.scale,
      static_cast<__nv_bfloat16*>(a.y), a.part, a.b, a.m, a.n, a.scols, a.gs,
      a.gps);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long bm = (long long)a.b * a.m;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((bm + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tcgemv_merge, (const float*)a.part,
                         static_cast<__nv_bfloat16*>(a.y), a.splits, bm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_tc_nt(const Args& a, int* occ) {
  if (a.b <= 8) return launch_tc<1, PACKED>(a, occ);
  return launch_tc<2, PACKED>(a, occ);
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
      if (!BF16 || a.b > SMALL_BATCH_MAX || a.gs % Tc<PACKED>::KR != 0 ||
          a.n % a.gs != 0 || !aligned16(a.x) || !aligned16(a.codes) ||
          a.splits < 1 || a.gps < 1 || (long long)a.splits * a.gps < ng ||
          (long long)(a.splits - 1) * a.gps >= ng ||
          (a.splits > 1 && a.part == nullptr))
        return (int)cudaErrorInvalidValue;
      return launch_tc_nt<PACKED>(a, nullptr);
    case MMA: {
      if (!BF16 || a.n % MK != 0 || (a.scols != 1 && a.gs != MK) ||
          !aligned16(a.x) || !aligned16(a.codes))
        return (int)cudaErrorInvalidValue;
      const dim3 grid((unsigned)((a.m + MM - 1) / MM),
                      (unsigned)((a.b + MB - 1) / MB));
      mma_kernel<PACKED><<<grid, 128, 0, a.st>>>(
          static_cast<const __nv_bfloat16*>(a.x),
          static_cast<const int8_t*>(a.codes), a.scale,
          static_cast<__nv_bfloat16*>(a.y), a.b, a.m, a.n, a.scols);
      return (int)cudaGetLastError();
    }
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
// chose (0 gemv, 1 tcgemv, 2 mma, 3 tiled). `scols` is 1 (per-channel
// scales) or n / gs (per-group); `packed` says two 4-bit codes per byte;
// `bf16` says x and y are bfloat16 (else float32). tcgemv only: `splits`
// CTAs per row tile of `gps` scale groups each (splits * gps >= n / gs >
// (splits - 1) * gps), `part` float32 scratch of splits * B * M (unused,
// may be null, when splits == 1). Launches on `stream`, allocates nothing,
// does not synchronise. Returns the CUDA error of the launches (0: ok);
// cudaErrorInvalidValue when the variant cannot take the shape.
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

// How many CTAs of tcgemv's instance for (packed, batch b) an SM holds at
// once, into *out; the wrapper's split plan aims at a wave of them.
int dequant_matmul_tc_ctas_per_sm(int packed, int b, int* out) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, b, 1, 1, 1, 1,
               1, 1, nullptr};
  return packed ? launch_tc_nt<true>(a, out) : launch_tc_nt<false>(a, out);
}

}  // extern "C"
