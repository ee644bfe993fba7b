// Quantized-weight matmul  y[B, M] = x[B, N] @ (codes[M, N] * scale)^T  for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package,
//   repro/kernels/dequant_matmul.py : _dequant_matmul_kernel
// (wrapper dequant_matmul_pallas). Codes are int8, or two 4-bit nibbles per
// byte (low nibble = even column, sign-extended by arithmetic shifts);
// scales are float32, one per output row (M, 1) or one per row and group of
// `gs` columns (M, N/gs). x is float32 or bfloat16, accumulation is float32,
// y has x's type. The product is computed here, in the kernel's own body:
// codes are widened in registers and no dequantized weight is ever written
// to device memory.
//
// Three variants behind one entry point:
//
// * gemv_kernel (B <= 16, the decode step). Bound by bytes: the function
//   must read M*N bytes of int8 codes (M*N/2 when packed) and almost nothing
//   else. So it streams the weights once: a block of 8 warps owns 16 output
//   rows, stages up to 1024 columns of x for all its batch rows in shared
//   memory (so x comes from device memory once per block, not once per
//   row), and each lane reads one aligned 32-bit word of codes (16 bits when
//   packed) per 128-column step. All of a chunk's code words are requested
//   before x is staged, so the two latencies overlap and each lane keeps up
//   to 64 bytes of weights in flight. A 128-column step lies inside one
//   scale group, so the scale multiplies the lane's partial dot product once
//   per step. Partial sums are reduced over the warp by shuffles at the end.
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

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

template <bool PACKED, bool BF16>
void launch(const void* x, const int8_t* codes, const float* scale, void* y,
            int b, int m, int n, int scols, int gs, cudaStream_t st) {
  if (b <= 16) {
    launch_gemv<PACKED, BF16>(x, codes, scale, y, b, m, n, scols, gs, st);
  } else if (BF16 && n % MK == 0 && (scols == 1 || gs == MK) &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(codes) % 16 == 0) {
    const dim3 grid((unsigned)((m + MM - 1) / MM), (unsigned)((b + MB - 1) / MB));
    mma_kernel<PACKED><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), codes, scale,
        static_cast<__nv_bfloat16*>(y), b, m, n, scols);
  } else {
    const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)((b + TB - 1) / TB));
    tiled_kernel<PACKED, BF16><<<grid, 256, 0, st>>>(x, codes, scale, y, b, m,
                                                     n, scols, gs);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches on `stream`,
// allocates nothing, does not synchronise. `scols` is 1 (per-channel scales)
// or n / gs (per-group); `packed` says two 4-bit codes per byte; `bf16` says
// x and y are bfloat16 (else float32).
extern "C" int dequant_matmul_launch(const void* x, const void* codes,
                                     const void* scale, void* y, int b, int m,
                                     int n, int scols, int gs, int packed,
                                     int bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scale);
  if (packed) {
    if (bf16) launch<true, true>(x, c, s, y, b, m, n, scols, gs, st);
    else launch<true, false>(x, c, s, y, b, m, n, scols, gs, st);
  } else {
    if (bf16) launch<false, true>(x, c, s, y, b, m, n, scols, gs, st);
    else launch<false, false>(x, c, s, y, b, m, n, scols, gs, st);
  }
  return (int)cudaGetLastError();
}
