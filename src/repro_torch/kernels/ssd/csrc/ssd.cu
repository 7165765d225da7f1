// Mamba2 SSD chunk scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel ssd_kernel (src/repro/kernels/ssd/kernel.py:65,
// pallas_call :84, body :29). Per (batch b, head h) and chunk c of Q tokens,
// with la the in-chunk cumulative sum of loga = A[h] dt and xd = x * dt:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) xd_j  +  exp(la_i) C_i . H_c^T
//   H_c+1 = exp(la_Q) H_c + S_c,   S_c = sum_j exp(la_Q - la_j) xd_j (x) B_j    H: (P, N)
// starting from H_0 = 0 (the serving prefill's state, as in the TPU kernel).
// It writes y (b, S, h, P) and the final state (b, h, P, N), which the decode
// cache needs (the TPU kernel kept it only in VMEM scratch). B and C are read
// by batch index from (b, S, N): the per-head copies the JAX op makes
// (ssd/ops.py:11) are not needed. A ragged last chunk reads as zeros past S
// (dt = loga = 0: decay 1, no update), and y is written only below S.
//
// What bounds it on this card: tensor-core operations. At the mamba2-130m
// prefill's launch shape (b 4, S 512, 24 heads, P 64, N 128, Q 128) the work
// is 2.83e9 operations (the causal triangle once) over 31 MB; the
// fp32-accurate scheme below issues three TF32 products for each, 8.5e9 at
// 495 TFLOP/s = 0.0172 ms, against 0.009 ms for the bytes.
//
// Design. The TPU kernel walks the chunks of a (b, h) row in order, carrying
// H in VMEM; on Hopper that is 96 blocks for 132 SMs, each serial. Here the
// SSD's own chunk decomposition runs every chunk in parallel, in three
// launches, the first and third with one block per (b, h, chunk):
//  1. ssd_chunk_state: S_c = (xd o w)^T . B with w_j = exp(la_Q - la_j), a
//     (P x N) product over K = Q, into a scratch (b, h, chunks, P, N) that the
//     wrapper allocates, and exp(la_Q) into a (b, h, chunks) scratch.
//  2. ssd_state_pass: the only sequential part. One thread per (b, h, p, n)
//     walks the chunks, overwriting S_c in place with H_c, the state entering
//     chunk c (H_0 = 0, H_c+1 = exp(la_Q,c) H_c + S_c), and writes the final
//     state.
//  3. ssd_chunk_output: y = exp(la) o (C . H_c^T) + G . xd, G = (C . B^T) o
//     causal decay. Two warps own 16 query rows: each multiplies C . H_c^T
//     for half of y's P columns and C . B^T for every other 8-key tile, and
//     G goes from its C . B^T accumulators into the A fragments of G . xd
//     without leaving registers (the TF32 A fragment's k-index t stands for
//     key 2t and t + 4 for key 2t + 1, and xd's B fragment reads the same
//     keys); the pair's two y tiles are added through shared memory at the
//     end. 16 warps (not 8, one to a row block) hide more of the MMA and
//     shared-memory latency of the one block an SM that shared memory
//     allows (PERF.md has the times of both, from chip_smoke.py). The causal
//     triangle is skipped by 8-key tiles: a warp multiplies only the keys up
//     to its rows' last. Warps w, w + 4, w + 8 and w + 12 share a scheduler,
//     and pair w % 8 takes row block w % 8 below 4 and 11 - w % 8 above, so
//     each scheduler gets row blocks k and 7 - k, the same work.
// In-chunk cumulative sums are warp scans (shuffles), not one thread's loop.
// Products: mma.sync.m16n8k8 TF32 in the 3xTF32 scheme of flash.cu: each
// operand x = big + small with big and small TF32 values, a product is
// a_small.b_big + a_big.b_small + a_big.b_big accumulated in fp32; here the
// two parts are truncated (split() below), not rounded, which leaves about
// 2^-20 of each product, where one TF32 pass loses 2^-10: at the prefill
// shape the kernel stays within 0.04 of the 1e-4 tolerance on the card
// (chip_smoke.py phase 2), where a single pass, as tests/test_torch_ssd.py
// emulates it, misses the tolerance many times over.
// Operands are split in registers as their fragments load: the three
// products need raw B, C, x and H_c tiles of 67.6 + 67.6 + 34.8 + 33.8 KB in
// shared memory at the prefill shape (one block an SM), and split {big,
// small} pairs would double that past the 227 KB a block may have. The
// split costs 4 ALU instructions per 3 MMAs.
// bf16 inputs (the model's bf16 x, B and C; the TPU kernel's own rule:
// inputs in their dtype, upcast in the kernel, the state fp32, y in x's
// dtype) are converted to fp32 as they are staged into the same fp32 tiles,
// so the math above runs unchanged; y is rounded to bf16 as it is written.
// dt and loga stay fp32, as the model computes them. The bf16 instance
// loads its tiles 16 bytes (8 values) at a time and widens them as it
// stores them, where P and N are multiples of 8 (H_c's fp32 rows by
// cp.async as in the fp32 instance): 0.133 ms at the prefill shape, the
// fp32 instance's time, where plain 2-byte loads for every tile took 0.234
// (H100 SXM at 700 W, chip_smoke.py phase 24g, PERF.md §6).
// Shared memory, the layout padded so fragment loads hit distinct banks
// (row strides = 8 mod 32 floats for the K-major reads of launch 1, 4 mod 32
// for launch 3): launch 1, 4 (Qp (Pp + 8) + Qp (Np + 8) + 3 Qp + 8) bytes =
// 108,064 at the prefill shape (two blocks an SM); launch 3, 4 (2 Qp (Np + 4)
// + Pp (Np + 4) + Qp (Pp + 4) + 2 Qp + 16) = 204,864. Qp, Pp: Q and P rounded
// up to 16; Np: N rounded up to 8. Q <= 128 and P <= 64 (registers).
// exp is the precise expf; tiles arrive by 16-byte cp.async where rows are
// 16-byte aligned (plain loads otherwise). Launch 3 runs C . H_c^T and
// C . B^T in one pass over N, so each C fragment is split once for both;
// that beat overlapping B's and x's loads with C . H_c^T (a second copy
// group) in development, and unrolling the pass twice gained a little more.
// What still holds it back (H100 SXM at 700 W, the prefill shape,
// chip_smoke.py phase 5): 0.133 ms a call = 0.035 (launch 1) + 0.009 (launch
// 2) + 0.087 (launch 3). Development builds of launch 3 without its
// products, or with one TF32 pass instead of three, showed both the tile
// loads, which one resident block an SM cannot overlap with compute, and
// MMA and shared-memory latency that the one block's warps hide poorly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kOutThreads = 512;  // launch 3: 16 warps, two to a block of 16 query rows
constexpr int kOutWarps = kOutThreads / 32;
constexpr int kMaxQ = 128;  // chunk: 8 warps of 16 query rows
constexpr int kMaxP = 64;   // head dim: y's 16 x P tile is 8 accumulator tiles
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPassBatch = 8;  // chunks whose states the state pass loads together

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big = x with its low 13 mantissa bits cleared (a TF32
// value), small = x - big (exact in fp32). The tensor cores read a TF32
// operand's top 19 bits, so small enters the product truncated to TF32: two
// ALU instructions a value, where cvt.rna.tf32 takes three with the
// subtraction; the kernel ran markedly slower with it in development.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[OFF + j] += a . b_j for the first `count` of NT n-tiles, in 3xTF32: a
// split as {big ab, small as}; b_j's fragment is (b[j * step], b[j * step +
// off]) raw, split here. Four tiles at a time: their small products go
// first, then their big ones, so consecutive MMAs do not wait on each other.
template <int OFF = 0, int NT = 8, int NA>
__device__ __forceinline__ void mma3_tiles(float (&acc)[NA][4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float* b, int step,
                                           int off, int count) {
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += 4) {
    uint32_t b0b[4], b0s[4], b1b[4], b1s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j0 + j < count) {
        split(b[(j0 + j) * step], b0b[j], b0s[j]);
        split(b[(j0 + j) * step + off], b1b[j], b1s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + j < count) mma_tf32(acc[OFF + j0 + j], as, b0b[j], b1b[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + j < count) mma_tf32(acc[OFF + j0 + j], ab, b0s[j], b1s[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + j < count) mma_tf32(acc[OFF + j0 + j], ab, b0b[j], b1b[j]);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Stage `rows` rows of `cols` values (row r at src + r * row_stride; rows >=
// valid and columns >= cols read as 0) into dst[r * dst_stride + c] as fp32,
// c < cols_p. vec: 16-byte rows pieces (16-byte aligned rows, cols and
// cols_p multiples of 16 / sizeof(T), dst rows 16-byte aligned): fp32 by
// cp.async, bf16 as one 16-byte load of 8 values widened to two float4
// stores; otherwise plain loads, converted, and stores.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int dst_stride, const T* src,
                                      long long row_stride, int rows, int valid, int cols,
                                      int cols_p, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int per_row = cols_p / V;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const bool in = r < valid && c < cols;
      if constexpr (sizeof(T) == 4) {
        cp_async16(dst + r * dst_stride + c, in ? src + r * row_stride + c : src, in ? 16 : 0);
      } else {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (in) raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
        // a bf16 value is the top half of its fp32 bits; the lower address is the low half
        float4* to = reinterpret_cast<float4*>(dst + r * dst_stride + c);
        to[0] = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                            __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
        to[1] = make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                            __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols_p; e += blockDim.x) {
      const int r = e / cols_p, c = e - r * cols_p;
      dst[r * dst_stride + c] = (r < valid && c < cols) ? to_f32(src[r * row_stride + c]) : 0.f;
    }
  }
}

// The chunk's dt and loga rows (0 past `valid`) into dts and la, then la
// becomes the in-chunk inclusive cumulative sum: a shuffle scan in each warp
// of 32 rows, plus the totals of the warps before. Every thread calls it.
__device__ __forceinline__ void chunk_cumsum(float* la, float* dts, float* tot,
                                             const float* loga, const float* dt,
                                             long long tok0, int nh, int h, int valid,
                                             int Qp) {
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  float v = 0.f;
  if (j < Qp) {
    const bool in = j < valid;
    v = in ? loga[(tok0 + j) * nh + h] : 0.f;
    dts[j] = in ? dt[(tok0 + j) * nh + h] : 0.f;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += tot[w];
  if (j < Qp) la[j] = v + base;
  __syncthreads();
}

struct Shape {
  int S, nh, P, N, Q, nc;  // sequence, heads, head dim, state, chunk, chunks
  int Pp, Np, Qp;          // padded: P and Q to 16, N to 8
};

// ------------------------------------------------------ 1. chunk states --
// S_c[p][n] = sum_j xdw[j][p] B[j][n], xdw = x dt exp(la_Q - la). A warp
// takes units of 16 rows of p x 64 columns of n.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state(const T* __restrict__ x,         // (b, S, nh, P)
                const float* __restrict__ dt,    // (b, S, nh)
                const float* __restrict__ loga,  // (b, S, nh)
                const T* __restrict__ Bm,        // (b, S, N)
                float* __restrict__ states,      // (b, nh, nc, P, N)
                float* __restrict__ decay,       // (b, nh, nc)
                Shape d, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int xs = d.Pp + 8, bs = d.Np + 8;
  float* Xs = smem;              // Qp x xs
  float* Bs = Xs + d.Qp * xs;    // Qp x bs
  float* la = Bs + d.Qp * bs;    // Qp
  float* dts = la + d.Qp;        // Qp
  float* ws = dts + d.Qp;        // Qp
  float* tot = ws + d.Qp;        // kWarps

  const int blk = blockIdx.x;  // (b, h, c)
  const int c = blk % d.nc, bh = blk / d.nc;
  const int b = bh / d.nh, h = bh - b * d.nh;
  const int valid = min(d.Q, d.S - c * d.Q);
  const long long tok0 = (long long)b * d.S + (long long)c * d.Q;
  stage(Xs, xs, x + (tok0 * d.nh + h) * d.P, (long long)d.nh * d.P, d.Qp, valid, d.P, d.Pp, vec);
  stage(Bs, bs, Bm + tok0 * d.N, d.N, d.Qp, valid, d.N, d.Np, vec);
  cp_async_commit();
  chunk_cumsum(la, dts, tot, loga, dt, tok0, d.nh, h, valid, d.Qp);
  const float last = la[d.Q - 1];
  for (int j = threadIdx.x; j < d.Qp; j += kThreads) ws[j] = expf(last - la[j]);
  if (threadIdx.x == 0) decay[blk] = expf(last);
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < d.Qp * d.Pp; e += kThreads) {
    const int j = e / d.Pp, p = e - j * d.Pp;
    Xs[j * xs + p] = Xs[j * xs + p] * dts[j] * ws[j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = d.Pp / 16, units = mtiles * ((d.Np + 63) / 64);
  float* out = states + (long long)blk * d.P * d.N;
  for (int u = warp; u < units; u += kWarps) {
    const int p0 = (u % mtiles) * 16, n0 = (u / mtiles) * 64;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < d.Qp; kk += 8) {
      // A = xdw^T: A[p][j] = Xs[j][p]
      const float* xa = Xs + (kk + t) * xs + p0 + g;
      uint32_t ab[4], as[4];
      split(xa[0], ab[0], as[0]);
      split(xa[8], ab[1], as[1]);
      split(xa[4 * xs], ab[2], as[2]);
      split(xa[4 * xs + 8], ab[3], as[3]);
      mma3_tiles(acc, ab, as, Bs + (kk + t) * bs + n0 + g, 8, 4 * bs, (d.Np - n0) / 8);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = p0 + g + 8 * (cc >> 1), n = n0 + j * 8 + 2 * t + (cc & 1);
        if (p < d.P && n < d.N) out[(long long)p * d.N + n] = acc[j][cc];
      }
    }
  }
}

// -------------------------------------------------------- 2. state pass --
// In place: states[b, h, c] = H_c (the state entering chunk c); the final
// state into hout. One thread per (p, n) of a (b, h) row.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states,       // (b, nh, nc, P, N)
               const float* __restrict__ decay,  // (b, nh, nc)
               float* __restrict__ hout,         // (b, nh, P, N)
               int nc, int PN) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.x;
  float* st = states + bh * nc * PN + e;
  const float* dec = decay + bh * nc;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {  // a batch of chunks' loads in flight
    float s[kPassBatch], dc[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const bool in = c0 + i < nc;
      s[i] = in ? st[(long long)(c0 + i) * PN] : 0.f;
      dc[i] = in ? dec[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        st[(long long)(c0 + i) * PN] = run;
        run = dc[i] * run + s[i];
      }
    }
  }
  hout[bh * PN + e] = run;
}

// ------------------------------------------------------------ 3. output --
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_chunk_output(const T* __restrict__ x,           // (b, S, nh, P)
                 const float* __restrict__ dt,      // (b, S, nh)
                 const float* __restrict__ loga,    // (b, S, nh)
                 const T* __restrict__ Bm,          // (b, S, N)
                 const T* __restrict__ Cm,          // (b, S, N)
                 const float* __restrict__ states,  // (b, nh, nc, P, N): H_c
                 T* __restrict__ y,                 // (b, S, nh, P)
                 Shape d, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int cs = d.Np + 4, xs = d.Pp + 4;
  float* Cs = smem;             // Qp x cs
  float* Bs = Cs + d.Qp * cs;   // Qp x cs
  float* Hs = Bs + d.Qp * cs;   // Pp x cs
  float* Xs = Hs + d.Pp * cs;   // Qp x xs: x, then x * dt, then half-sums of y
  float* la = Xs + d.Qp * xs;   // Qp
  float* dts = la + d.Qp;       // Qp
  float* tot = dts + d.Qp;      // kOutWarps

  const int blk = blockIdx.x;  // (b, h, c)
  const int c = blk % d.nc, bh = blk / d.nc;
  const int b = bh / d.nh, h = bh - b * d.nh;
  const int valid = min(d.Q, d.S - c * d.Q);
  const long long tok0 = (long long)b * d.S + (long long)c * d.Q;
  stage(Cs, cs, Cm + tok0 * d.N, d.N, d.Qp, valid, d.N, d.Np, vec);
  stage(Hs, cs, states + (long long)blk * d.P * d.N, d.N, d.Pp, d.P, d.N, d.Np, vec);
  stage(Bs, cs, Bm + tok0 * d.N, d.N, d.Qp, valid, d.N, d.Np, vec);
  stage(Xs, xs, x + (tok0 * d.nh + h) * d.P, (long long)d.nh * d.P, d.Qp, valid, d.P, d.Pp, vec);
  cp_async_commit();
  chunk_cumsum(la, dts, tot, loga, dt, tok0, d.nh, h, valid, d.Qp);

  // two warps to a block of 16 query rows: half 0 multiplies C . H_c^T for
  // P columns 0-31 and the even 8-key tiles, half 1 columns 32-63 and the
  // odd tiles; their y tiles are added at the end. Warps w, w + 4, w + 8 and
  // w + 12 share a scheduler and take row blocks k, 7 - k, k, 7 - k.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp & 7, half = warp >> 3;
  const int rb = q < 4 ? q : 11 - q;
  const int r0 = rb * 16;
  const bool active = r0 < d.Qp && r0 < valid;
  const int ptiles = d.Pp / 8;
  const float* ca = Cs + (r0 + g) * cs;  // this thread's A rows: r0 + g and r0 + g + 8

  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < d.Qp * d.Pp; e += kOutThreads) {
    const int j = e / d.Pp, p = e - j * d.Pp;
    Xs[j * xs + p] *= dts[j];
  }
  __syncthreads();

  float yacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
  const int nkt = min(2 * (rb + 1), d.Qp / 8);
  const int mine = (nkt - half + 1) / 2;  // key tiles j = 2 i + half < nkt
  const int hp = min(4, ptiles - 4 * half);  // this half's P tiles of C . H_c^T
  if (active) {
    float sacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
    // one pass over N for both products that take C as their A operand
#pragma unroll 2
    for (int kk = 0; kk < d.Np; kk += 8) {
      uint32_t ab[4], as[4];
      split(ca[kk + t], ab[0], as[0]);
      split(ca[8 * cs + kk + t], ab[1], as[1]);
      split(ca[kk + t + 4], ab[2], as[2]);
      split(ca[8 * cs + kk + t + 4], ab[3], as[3]);
      // B[k = n][col = p] = H[p][n]; B[k = n][col = key] = B_key[n]
      if (half == 0)
        mma3_tiles<0, 4>(yacc, ab, as, Hs + g * cs + kk + t, 8 * cs, 4, hp);
      else
        mma3_tiles<4, 4>(yacc, ab, as, Hs + (32 + g) * cs + kk + t, 8 * cs, 4, hp);
      mma3_tiles(sacc, ab, as, Bs + (8 * half + g) * cs + kk + t, 16 * cs, 4, mine);
    }
    {  // each row of C . H_c^T times exp(la_i)
      const float e0 = expf(la[r0 + g]), e1 = expf(la[r0 + g + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        yacc[n][0] *= e0;
        yacc[n][1] *= e0;
        yacc[n][2] *= e1;
        yacc[n][3] *= e1;
      }
    }

    // G = S o exp(la_i - la_j) on and below the diagonal, 0 above (selected,
    // never multiplied: exp overflows above the diagonal under strong decay)
    const float la0 = la[r0 + g], la1 = la[r0 + g + 8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < mine) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int row = r0 + g + 8 * (cc >> 1), key = (2 * i + half) * 8 + 2 * t + (cc & 1);
          float& sv = sacc[i][cc];
          sv = key <= row ? sv * expf((cc < 2 ? la0 : la1) - la[key]) : 0.f;
        }
      }
    }

    // y += G . xd over this half's key tiles: G's accumulators are the A
    // fragments (k-index t -> key 2t, t + 4 -> key 2t + 1), xd's B fragment
    // reads the same keys
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < mine) {
        uint32_t ab[4], as[4];
        split(sacc[i][0], ab[0], as[0]);  // (g,     key 2t)
        split(sacc[i][2], ab[1], as[1]);  // (g + 8, key 2t)
        split(sacc[i][1], ab[2], as[2]);  // (g,     key 2t + 1)
        split(sacc[i][3], ab[3], as[3]);  // (g + 8, key 2t + 1)
        mma3_tiles(yacc, ab, as, Xs + ((2 * i + half) * 8 + 2 * t) * xs + g, 8, xs, ptiles);
      }
    }
  }

  // half 1 hands its y tile to half 0 through the x rows it no longer needs
  __syncthreads();
  float* part = Xs + (r0 + g) * xs + 2 * t;
  if (active && half == 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < ptiles) {
        part[n * 8] = yacc[n][0];
        part[n * 8 + 1] = yacc[n][1];
        part[8 * xs + n * 8] = yacc[n][2];
        part[8 * xs + n * 8 + 1] = yacc[n][3];
      }
    }
  }
  __syncthreads();
  if (!active || half == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= valid) continue;
    T* dst = y + ((tok0 + row) * d.nh + h) * d.P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = n * 8 + 2 * t + cc;
        if (col < d.P) store(dst + col, yacc[n][2 * i + cc] + part[8 * i * xs + n * 8 + cc]);
      }
    }
  }
}

Shape make_shape(int S, int nh, int P, int N, int Q) {
  Shape d;
  d.S = S;
  d.nh = nh;
  d.P = P;
  d.N = N;
  d.Q = Q;
  d.nc = (S + Q - 1) / Q;
  d.Pp = (P + 15) & ~15;
  d.Np = (N + 7) & ~7;
  d.Qp = (Q + 15) & ~15;
  return d;
}

long long state_smem(const Shape& d) {
  return 4LL * ((long long)d.Qp * (d.Pp + 8) + (long long)d.Qp * (d.Np + 8) + 3LL * d.Qp + kWarps);
}
long long output_smem(const Shape& d) {
  return 4LL * (2LL * d.Qp * (d.Np + 4) + (long long)d.Pp * (d.Np + 4) +
                (long long)d.Qp * (d.Pp + 4) + 2LL * d.Qp + kOutWarps);
}

// Opt `kernel` into `smem` bytes of dynamic shared memory (once per size)
// and all of the SM's unified memory as shared memory.
template <typename K>
cudaError_t opt_in(K kernel, long long smem, long long& opted) {
  if (smem <= opted) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) opted = smem;
  return err;
}

// Three launches on `stream`: chunk states, the state pass, the output, for
// x, B, C and y of type T.
template <typename T>
int forward(const T* x, const float* dt, const float* loga, const T* B, const T* C, T* y,
            float* h, float* states, float* decay, int batch, const Shape& d,
            cudaStream_t s) {
  const long long blocks = (long long)batch * d.nh * d.nc;
  const long long PN = (long long)d.P * d.N;
  static long long opted_state = 0, opted_output = 0;  // one pair an instance
  const long long smem1 = state_smem(d), smem3 = output_smem(d);
  cudaError_t err = opt_in(ssd_chunk_state<T>, smem1, opted_state);
  if (err == cudaSuccess) err = opt_in(ssd_chunk_output<T>, smem3, opted_output);
  if (err != cudaSuccess) return (int)err;
  // 16-byte pieces of every staged row: x, B, C (16 / sizeof(T) values) and
  // the fp32 states (4 values; a multiple of 8 is one of 4)
  constexpr int V = 16 / sizeof(T);
  const bool vec = d.P % V == 0 && d.N % V == 0 &&
                   (((uintptr_t)x | (uintptr_t)B | (uintptr_t)C | (uintptr_t)states) & 15) == 0;

  ssd_chunk_state<T><<<(unsigned)blocks, kThreads, (size_t)smem1, s>>>(x, dt, loga, B, states,
                                                                       decay, d, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 pass_grid((unsigned)(batch * d.nh), (unsigned)((PN + kThreads - 1) / kThreads));
  ssd_state_pass<<<pass_grid, kThreads, 0, s>>>(states, decay, h, d.nc, (int)PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_output<T><<<(unsigned)blocks, kOutThreads, (size_t)smem3, s>>>(x, dt, loga, B, C,
                                                                        states, y, d, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the larger of the two chunk launches needs at (P, N,
// Q), in bytes (the same for either input type: tiles are staged as fp32).
extern "C" long long ssd_smem_bytes(int P, int N, int Q) {
  const Shape d = make_shape(1, 1, P, N, Q);
  const long long a = state_smem(d), b = output_smem(d);
  return a > b ? a : b;
}

// dtype: the type of x, B, C and y, 0 = float32, 1 = bfloat16 (dt, loga,
// the final state h and the scratch are float32). states (b, nh, chunks, P,
// N) and decay (b, nh, chunks) are the caller's scratch. Returns the first
// failing cudaError_t (0 = success).
extern "C" int ssd_forward(const void* x, const float* dt, const float* loga, const void* B,
                           const void* C, void* y, float* h, float* states, float* decay,
                           int dtype, int batch, int S, int nh, int P, int N, int Q,
                           void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0 || P <= 0 || N <= 0 || Q <= 0 || P > kMaxP || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  const Shape d = make_shape(S, nh, P, N, Q);
  const long long blocks = (long long)batch * nh * d.nc;
  const long long PN = (long long)P * N;
  if (blocks > INT_MAX || (PN + kThreads - 1) / kThreads > 65535 ||
      (long long)batch * nh > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return forward<float>((const float*)x, dt, loga, (const float*)B, (const float*)C,
                          (float*)y, h, states, decay, batch, d, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>((const __nv_bfloat16*)x, dt, loga, (const __nv_bfloat16*)B,
                                  (const __nv_bfloat16*)C, (__nv_bfloat16*)y, h, states, decay,
                                  batch, d, s);
  return (int)cudaErrorInvalidValue;
}
