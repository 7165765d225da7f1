// Causal flash attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash/kernel.py:74, pallas_call :102, body :29).
//
// For every batch b, query head h and query row i, with qp_i and kp_j the
// positions of query row i and key j:
//   s_ij = softcap( scale * (q_i . k_j) )          scale = 1/sqrt(hd)
//   ok_ij = kp_j <= qp_i  and  (window <= 0  or  qp_i - kp_j < window)
//   out_i = sum_j p_ij v_j / max(sum_j p_ij, 1e-30),  p_ij = ok_ij exp(s_ij - m_i)
// with an online softmax over KV tiles (running max m, sum l, accumulator),
// in fp32 whatever the input type (fp32 or bf16; the output takes q's type).
// Positions are int32 vectors q_pos (Sq) and kv_pos (Skv), both
// non-decreasing (the model's rope positions, or m-rope's t-row, where a
// frontend prefix shares t = 0 and so sees itself both ways); null pointers
// stand for 0-based row indices, the index path, a template instance of
// its own that is today's kernel unchanged.
// GQA: query head h reads kv head h / (H / KV) — the Pallas kernel's kv_row
// fold (:99) in the model's (B, S, heads, dim) layout, which this kernel
// reads and writes directly, so the op moves no axis.
//
// What bounds it on this card: tensor-core operations. At the serving
// prefill's shape (4 sequences x 32 heads, S 512, hd 128, causal) the work
// is 8.67e9 operations over 134 MB: the fp32-accurate scheme below issues
// three TF32 products for each, 2.6e10 at 495 TFLOP/s = 0.0525 ms, against
// 0.040 ms for the bytes. In practice latency bounds it: one resident block
// of 8 warps an SM (registers) leaves 2 warps a scheduler, the block's
// barriers idle the warps whose rows a diagonal tile does not reach, and
// each K/V tile is split before any warp can multiply it.
//
// Design (FlashAttention-2 style, warp-level mma.sync):
// * A block of NW warps owns BQ = 16 NW query rows of one (b, h); each warp
//   owns 16 rows. S = Q.K^T for a 16 x BKV tile, the running (m, l) of its
//   two rows per thread and the 16 x hd_v output stay in registers, in the
//   mma accumulator layout; P never leaves registers.
// * fp32 accumulates in short chains: each 16-wide k-step of S, and each
//   KV tile's share of a block of 8 output tiles of P.V, goes into a fresh
//   accumulator that is then added to S or O with an fp32 add. An MMA adds
//   its accumulator input with truncation at that input's magnitude, so
//   one long chain (S over all of hd, O over all keys) drifts with the
//   chain's length: at a full-width model's activations (arctic-480b,
//   scores to ~30) it held the output further from float64 than the
//   1e-5 tolerance allows, the short chains well inside it (PERF.md §6).
// * fp32 runs 3xTF32: each operand x is split into big = tf32(x) and
//   small = tf32(x - big), and a product is a_small.b_big + a_big.b_small +
//   a_big.b_big, accumulated in fp32 (mma.sync.m16n8k8 TF32), for S and for
//   P.V alike. The dropped a_small.b_small term and the rounding of the
//   small parts leave about 2^-21 of each product: fp32-grade, where a
//   single TF32 pass keeps 2^-11 and misses the 1e-5 parity. Q and P are
//   split on their fragments in registers; each landed K/V tile is split
//   once, by the whole block, into a {big, small} buffer, so the 8 warps do
//   not each split every K/V element again.
//   bf16 inputs run bf16 MMAs (m16n8k16) for S: q and k are bf16 values,
//   so each product is exact and accumulates in fp32. P.V keeps P
//   fp32-accurate, as the TPU kernel keeps P in fp32 for P.V: each p is
//   split into a bf16 high part and the bf16 rounding of the rest, p = hi +
//   lo to about 2^-17 of p, and two products, lo.V then hi.V, accumulate in
//   fp32; V is exact in bf16. Rounding P to bf16 alone (one product, the
//   instance before) dropped p's bits past 2^-9, where the plain version
//   multiplies P in fp32. With the split, 0.016% of the codeqwen prefill
//   launch's outputs are more than one ulp from the plain version at their
//   own magnitude, all below 5e-4 of outputs up to ~5 (chip_smoke.py phase
//   24g): there two fp32 roundings of one value differ by many of its ulps.
// * P.V takes P from the S accumulators without a shuffle: within each
//   group of 8 keys, the k-index t of the TF32 A fragment stands for key 2t
//   and t + 4 for key 2t + 1, and V's B fragment reads the same keys.
// * K/V tiles come in with cp.async (16-byte copies, zero-filled past Skv
//   and past hd), tile it + 1 loading while tile it is multiplied: fp32
//   keeps one raw buffer, free again once its tile is split; bf16 a ring of
//   two, which the fragments read directly. Q is staged once. Raw strides
//   are padded by 16 bytes and the {big, small} strides by 4 and 2 pairs, so
//   the fragment loads hit distinct banks.
// * exp is ex2.approx (__expf): a few ulp, far inside the 1e-5 parity.
// * The grid launches the heaviest query tiles first (the tile index runs
//   backwards), so the causal tail is not left to the end of the launch.
//   KV tiles wholly above the diagonal or outside the window are not
//   visited; inside a tile, a warp whose 16 rows see none of its keys
//   skips it, and key groups past the warp's last row are not multiplied.
//   With positions, the same bounds come from positions: monotone vectors
//   make the block's key range [first key within the window of its first
//   row's position, last key at or before its last row's position] a
//   search each (by the whole warp, 32 probes a round), and a tile is
//   skipped or fully unmasked by its
//   first and last key's positions (kept in shared memory beside K, one
//   4-byte cp.async a key; each thread keeps its two rows' positions in
//   registers).
// * Why mma.sync and not wgmma: wgmma TF32 needs both operands K-major in
//   shared memory, so V would be transposed on its way in, and its operands
//   come from shared memory, so the split tiles of Q, K and V would all
//   live there (Q alone is 135 KB split at 128 rows x hd 128). mma.sync
//   takes Q and P split in registers. wgmma is the step after, if MMA issue
//   is the limit.
// * Why 8 warps and not 4: K/V tiles are staged and split once per block,
//   so 128-row blocks halve that work per row; two resident 64-row blocks
//   an SM ran markedly slower.
//
// Configurations (T, NW, BKV, widest of hd and hd_v padded to 16), shared
// memory = sizeof(T) (BQ (hd+pad) + RAW BKV ((hd+pad) + (hd_v+pad))), pad =
// 16 bytes, RAW = 1 for fp32 and 2 for bf16, plus 8 BKV ((hd + 4) +
// (hd_v + 2)) B of split pairs for fp32; registers a thread from -Xptxas
// -v (no spills unless noted); resident blocks an SM:
//   fp32 <= 64:   NW 8, BKV 32:  86,528 B, 242 registers: 1 (registers)
//   fp32 <= 128:  NW 8, BKV 32: 168,448 B, 255 registers (16-byte spill): 1
//   fp32 <= 256:  NW 4, BKV 16: 166,144 B, 255 registers: 1
//   bf16 <= 64:   NW 8, BKV 64:  55,296 B, 180 registers: 1 (registers)
//   bf16 <= 128:  NW 8, BKV 64: 104,448 B, 225 registers: 1 (registers)
//   bf16 <= 256:  NW 4, BKV 32: 101,376 B, 240 registers: 2
// The positions' instances add 8 BKV bytes (two tiles of key positions),
// and fp32 spills there: 28 bytes at <= 128, 12 at <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -2.0e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global -> shared; zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo: hi the bf16 pair nearest, lo the bf16 pair nearest
// the remainders
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// How many of a[0..n) (non-decreasing) are <= x, found by a whole warp
// (every lane calls it with the same x): each round probes 32 evenly
// spaced entries of [lo, hi) at once, so S <= 1024 takes two dependent
// loads, where a one-thread bisection takes log2(S).
__device__ __forceinline__ int warp_upper_bound(const int* a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    // the probes <= x are a prefix of the lanes: a is non-decreasing
    const int c = __popc(__ballot_sync(0xffffffffu, idx < hi && a[idx] <= x));
    if (c == 0) return lo;
    const int next_hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
    hi = next_hi;
  }
  return lo;
}

// Which 16-byte chunks of a staged tile one thread copies: column chunk c of
// rows r0, r0 + step, ... (chunks per row: cols_p / (16 / sizeof(T))).
struct ChunkMap {
  int c, r0, step;
  __device__ ChunkMap(int chunks, int threads) {
    const int per = threads / chunks;  // rows covered by one sweep of the block
    c = threadIdx.x % chunks;
    r0 = threadIdx.x < per * chunks ? threadIdx.x / chunks : 1 << 30;
    step = per;
  }
};

// Stage `rows` rows of `cols` elements (row r at src + r * row_stride; rows
// >= valid read as 0) into dst[r * dst_stride + c] for c < cols_p (columns
// past cols read as 0). vec: 16-byte cp.async copies (cols a multiple of
// 16 / sizeof(T), 16-byte aligned rows); otherwise plain loads and stores.
template <typename T, int THREADS>
__device__ __forceinline__ void stage(T* dst, int dst_stride, const T* src, long long row_stride,
                                      int rows, int valid, int cols, int cols_p, bool vec,
                                      const ChunkMap& map) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int c = map.c * V;
    for (int r = map.r0; r < rows; r += map.step) {
      const bool in = r < valid && c < cols;
      cp_async16(dst + r * dst_stride + c, in ? src + r * row_stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols_p; e += THREADS) {
      const int r = e / cols_p, c = e - r * cols_p;
      dst[r * dst_stride + c] = (r < valid && c < cols) ? src[r * row_stride + c] : T(0.f);
    }
  }
}

// fp32: split a staged raw tile (rows x cols_p, stride `raw_stride` floats)
// into {big, small} TF32 pairs (stride `sp_stride` pairs), four columns a
// thread at a time.
__device__ __forceinline__ void split_tile(uint2* dst, int sp_stride, const float* raw,
                                           int raw_stride, int rows, const ChunkMap& map) {
  const int c = map.c * 4;
#pragma unroll 4
  for (int r = map.r0; r < rows; r += map.step) {
    const float4 x = *reinterpret_cast<const float4*>(raw + r * raw_stride + c);
    uint4 lo, hi;
    split(x.x, lo.x, lo.y);
    split(x.y, lo.z, lo.w);
    split(x.z, hi.x, hi.y);
    split(x.w, hi.z, hi.w);
    uint4* to = reinterpret_cast<uint4*>(dst + r * sp_stride + c);
    to[0] = lo;
    to[1] = hi;
  }
}

// The block's pipeline over KV tiles, raw K/V filled with cp.async one tile
// ahead:
//   bf16 (a ring of two raw buffers, read by the warps' fragments):
//     wait for tile it; sync; issue tile it + 1; multiply tile it.
//   fp32 (one raw buffer, split once into a {big, small} buffer that the
//   warps' B fragments read, which frees the raw buffer for the next tile):
//     wait for tile it; sync; split it; sync; issue tile it + 1; multiply it.
// POS: mask by q_pos / kv_pos (key positions staged with their K tile, in a
// ring of two whatever RAW is: tile it + 1's land while tile it's are read).
template <typename T, int NW, int BKV, int HDV, bool POS>
__global__ void __launch_bounds__(NW * 32, 1)
flash_kernel(const T* __restrict__ q,        // (B, Sq, H, hd)
             const T* __restrict__ k,        // (B, Skv, KV, hd)
             const T* __restrict__ v,        // (B, Skv, KV, hd_v)
             T* __restrict__ out,            // (B, Sq, H, hd_v)
             const int* __restrict__ q_pos,  // (Sq,), POS only
             const int* __restrict__ kv_pos, // (Skv,), POS only
             int Sq, int Skv, int H, int KV, int hd, int hdv, float scale, int window,
             float softcap, bool vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BQ = 16 * NW;
  constexpr int THREADS = 32 * NW;
  constexpr int PAD = 16 / sizeof(T);
  constexpr int NT = BKV / 8;  // 8-key column tiles of S
  constexpr int NV = HDV / 8;  // 8-column tiles of the output
  constexpr int RAW = kF32 ? 1 : 2;  // raw K/V buffers
  static_assert(BKV % (kF32 ? 8 : 16) == 0 && HDV % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hdp = (hd + 15) & ~15, hdvp = (hdv + 15) & ~15;
  const int qst = hdp + PAD, vst = hdvp + PAD;  // raw strides (elements)
  const int kst2 = hdp + 4, vst2 = hdvp + 2;    // split strides ({big, small} pairs)
  T* Qs = reinterpret_cast<T*>(smem_raw);       // BQ x qst
  T* Ks = Qs + BQ * qst;                        // RAW x BKV x qst
  T* Vs = Ks + RAW * BKV * qst;                 // RAW x BKV x vst
  uint2* Ksp = reinterpret_cast<uint2*>(Vs + RAW * BKV * vst);  // fp32: BKV x kst2
  uint2* Vsp = Ksp + BKV * kst2;                              // fp32: BKV x vst2
  int* Kps = reinterpret_cast<int*>(kF32 ? Vsp + BKV * vst2 : Ksp);  // POS: 2 x BKV

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16, row_hi = row_lo + 15;

  // causal: no key after the block's last row; window: none before its reach
  int kv_end, kv_begin = 0;
  // POS: the warp's first and last rows' positions, the keys its last row
  // sees, and this thread's two rows' positions
  int qw_lo = 0, qw_hi = 0, warp_end = 0, qp[2] = {0, 0};
  if constexpr (POS) {
    kv_end = warp_upper_bound(kv_pos, Skv, q_pos[min(q0 + BQ, Sq) - 1]);
    if (window > 0) kv_begin = (warp_upper_bound(kv_pos, Skv, q_pos[q0] - window) / BKV) * BKV;
    qw_lo = q_pos[min(row_lo, Sq - 1)];
    qw_hi = q_pos[min(row_hi, Sq - 1)];
    warp_end = warp_upper_bound(kv_pos, Skv, qw_hi);
    qp[0] = q_pos[min(row_lo + g, Sq - 1)];
    qp[1] = q_pos[min(row_lo + g + 8, Sq - 1)];
  } else {
    kv_end = min(Skv, q0 + BQ);
    if (window > 0 && q0 - window + 1 > 0) kv_begin = ((q0 - window + 1) / BKV) * BKV;
  }
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  const T* qbase = q + ((long long)b * Sq * H + h) * hd + (long long)q0 * H * hd;
  const T* kbase = k + ((long long)b * Skv * KV + kvh) * hd;
  const T* vbase = v + ((long long)b * Skv * KV + kvh) * hdv;
  const long long kstride = (long long)KV * hd, vstride = (long long)KV * hdv;
  const ChunkMap kmap(hdp / PAD, THREADS), vmap(hdvp / PAD, THREADS);
  auto stage_kv = [&](int tile) {
    const int k0 = kv_begin + tile * BKV, buf = tile % RAW;
    stage<T, THREADS>(Ks + buf * BKV * qst, qst, kbase + k0 * kstride, kstride, BKV, Skv - k0,
                      hd, hdp, vec, kmap);
    stage<T, THREADS>(Vs + buf * BKV * vst, vst, vbase + k0 * vstride, vstride, BKV, Skv - k0,
                      hdv, hdvp, vec, vmap);
    if constexpr (POS) {
      if (threadIdx.x < BKV) {
        const bool in = k0 + (int)threadIdx.x < Skv;
        cp_async4(Kps + (tile & 1) * BKV + threadIdx.x, in ? kv_pos + k0 + threadIdx.x : kv_pos,
                  in ? 4 : 0);
      }
    }
  };
  stage<T, THREADS>(Qs, qst, qbase, (long long)H * hd, BQ, Sq - q0, hd, hdp, vec, kmap);
  if (ntiles > 0) stage_kv(0);
  cp_async_commit();

  float o[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();  // tile it (and Q) have landed
    __syncthreads();     // ... for every thread; and every warp is done with tile it - 1
    const int k0 = kv_begin + it * BKV;
    const T* Kb = Ks + (it % RAW) * BKV * qst;
    const T* Vb = Vs + (it % RAW) * BKV * vst;
    if constexpr (kF32) {
      split_tile(Ksp, kst2, reinterpret_cast<const float*>(Kb), qst, BKV, kmap);
      split_tile(Vsp, vst2, reinterpret_cast<const float*>(Vb), vst, BKV, vmap);
      __syncthreads();  // the split tile is ready and the raw buffer free
    }
    if (it + 1 < ntiles) stage_kv(it + 1);  // lands while this tile is multiplied
    cp_async_commit();

    const int* kp = Kps + (it & 1) * BKV;  // POS: this tile's key positions
    bool skip;
    if constexpr (POS)
      skip = row_lo >= Sq || k0 >= warp_end ||
             (window > 0 && qw_lo - kp[min(BKV, Skv - k0) - 1] >= window);
    else
      skip = row_lo >= Sq || k0 > row_hi || (window > 0 && k0 + BKV - 1 < row_lo - window + 1);
    if (skip) continue;

    // ------------------------------------------------------ S = Q.K^T --
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const T* qa = Qs + (warp * 16 + g) * qst;
    if constexpr (kF32) {
      auto step = [&](int kk, float (&acc)[NT][4]) {
        uint32_t ab[4], as[4];
        split(qa[kk + t], ab[0], as[0]);
        split(qa[8 * qst + kk + t], ab[1], as[1]);
        split(qa[kk + t + 4], ab[2], as[2]);
        split(qa[8 * qst + kk + t + 4], ab[3], as[3]);
        uint2 b0[NT], b1[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2* kb = Ksp + (j * 8 + g) * kst2 + kk + t;
          b0[j] = kb[0];
          b1[j] = kb[4];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], as, b0[j].x, b1[j].x);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ab, b0[j].y, b1[j].y);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ab, b0[j].x, b1[j].x);
      };
      // each 16-wide k-step into a fresh accumulator, added to S in fp32
#pragma unroll 4
      for (int kk = 0; kk < hdp; kk += 16) {
        float part[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
        step(kk, part);
        step(kk + 8, part);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] += part[j][c];
      }
    } else {
      const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(qa);
      const __nv_bfloat16* kbb = reinterpret_cast<const __nv_bfloat16*>(Kb);
#pragma unroll 4
      for (int kk = 0; kk < hdp; kk += 16) {
        const uint32_t a[4] = {ld32(qb + kk + 2 * t), ld32(qb + 8 * qst + kk + 2 * t),
                               ld32(qb + kk + 2 * t + 8), ld32(qb + 8 * qst + kk + 2 * t + 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* kb = kbb + (j * 8 + g) * qst + kk + 2 * t;
          mma_bf16(s[j], a, ld32(kb), ld32(kb + 8));
        }
      }
    }

    // -------------------------------------------- mask, online softmax --
    // thread holds rows row_lo + g (c = 0, 1) and + 8 (c = 2, 3), keys
    // k0 + 8 j + 2 t + (c & 1)
    bool full;
    if constexpr (POS)
      full = k0 + BKV <= Skv && kp[BKV - 1] <= qw_lo && (window <= 0 || qw_hi - kp[0] < window);
    else
      full = k0 + BKV - 1 <= row_lo && k0 + BKV <= Skv && (window <= 0 || row_hi - k0 < window);
    uint32_t okbits = 0xffffffffu;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!full) {
          const int kl = j * 8 + 2 * t + (c & 1);
          bool ok;
          if constexpr (POS) {
            const int qpos = qp[c >> 1], kpos = kp[kl];
            ok = k0 + kl < Skv && kpos <= qpos && (window <= 0 || qpos - kpos < window);
          } else {
            const int row = row_lo + g + (c >> 1) * 8, key = k0 + kl;
            ok = key < Skv && key <= row && (window <= 0 || row - key < window);
          }
          if (!ok) {
            okbits &= ~(1u << (j * 4 + c));
            x = kNeg;
          }
        }
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (okbits >> (j * 4 + c)) & 1u ? __expf(s[j][c] - m[c >> 1]) : 0.f;
        s[j][c] = p;
        rs[c >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // ------------------------------------------------------- O += P.V --
    // keys past kv_end or past the warp's last row carry p = 0
    int kmax;
    if constexpr (POS)
      kmax = warp_end - k0;
    else
      kmax = min(kv_end, row_hi + 1) - k0;
    if constexpr (kF32) {
      // each block of 8 output tiles gathers this tile's keys in a fresh
      // accumulator, added to O in fp32
#pragma unroll
      for (int n0 = 0; n0 < NV; n0 += 8) {
        if (n0 * 8 < hdvp) {
          float acc[8][4];
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j * 8 < kmax) {
              uint32_t ab[4], as[4];
              split(s[j][0], ab[0], as[0]);  // (g,   key 2t)
              split(s[j][2], ab[1], as[1]);  // (g+8, key 2t)
              split(s[j][1], ab[2], as[2]);  // (g,   key 2t+1)
              split(s[j][3], ab[3], as[3]);  // (g+8, key 2t+1)
              const uint2* vb = Vsp + (j * 8 + 2 * t) * vst2 + g;
              uint2 b0[8], b1[8];
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                if ((n0 + n) * 8 < hdvp) {
                  b0[n] = vb[(n0 + n) * 8];
                  b1[n] = vb[vst2 + (n0 + n) * 8];
                }
              }
#pragma unroll
              for (int n = 0; n < 8; ++n)
                if ((n0 + n) * 8 < hdvp) mma_tf32(acc[n], as, b0[n].x, b1[n].x);
#pragma unroll
              for (int n = 0; n < 8; ++n)
                if ((n0 + n) * 8 < hdvp) mma_tf32(acc[n], ab, b0[n].y, b1[n].y);
#pragma unroll
              for (int n = 0; n < 8; ++n)
                if ((n0 + n) * 8 < hdvp) mma_tf32(acc[n], ab, b0[n].x, b1[n].x);
            }
          }
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[n0 + n][c] += acc[n][c];
        }
      }
    } else {
      const __nv_bfloat16* vbb = reinterpret_cast<const __nv_bfloat16*>(Vb);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if (j2 * 16 < kmax) {
          // P's A fragment as a high and a low part (split_bf16)
          uint32_t ah[4], al[4];
          split_bf16(s[2 * j2][0], s[2 * j2][1], ah[0], al[0]);
          split_bf16(s[2 * j2][2], s[2 * j2][3], ah[1], al[1]);
          split_bf16(s[2 * j2 + 1][0], s[2 * j2 + 1][1], ah[2], al[2]);
          split_bf16(s[2 * j2 + 1][2], s[2 * j2 + 1][3], ah[3], al[3]);
          const __nv_bfloat16* vb = vbb + (j2 * 16 + 2 * t) * vst + g;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            if (n * 8 < hdvp) {
              const __nv_bfloat16* p = vb + n * 8;
              const uint32_t b0 = pack_bf16(p[0], p[vst]), b1 = pack_bf16(p[8 * vst], p[9 * vst]);
              mma_bf16(o[n], al, b0, b1);
              mma_bf16(o[n], ah, b0, b1);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + g + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + (((long long)b * Sq + row) * H + h) * hdv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n * 8 + 2 * t + c;
        if (col < hdv) store(dst + col, o[n][2 * i + c] / den);
      }
    }
  }
}

template <typename T, int NW, int BKV, int HDV, bool POS>
int launch(const void* q, const void* k, const void* v, void* out, const int* q_pos,
           const int* kv_pos, int B, int Sq, int Skv, int H, int KV, int hd, int hdv, float scale,
           int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = 16 * NW, PAD = 16 / sizeof(T);
  const int hdp = (hd + 15) & ~15, hdvp = (hdv + 15) & ~15;
  constexpr int RAW = sizeof(T) == 4 ? 1 : 2;
  size_t smem = sizeof(T) * ((size_t)BQ * (hdp + PAD) + RAW * (size_t)BKV * (hdp + PAD) +
                             RAW * (size_t)BKV * (hdvp + PAD));
  if (sizeof(T) == 4) smem += sizeof(uint2) * (size_t)BKV * ((hdp + 4) + (hdvp + 2));
  if (POS) smem += 2 * sizeof(int) * (size_t)BKV;
  static size_t opted = 0;  // dynamic shared memory this instantiation may use
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NW, BKV, HDV, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // all of the SM's unified memory as shared memory, so that every block
    // the registers allow can be resident
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_kernel<T, NW, BKV, HDV, POS>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = hd % V == 0 && hdv % V == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_kernel<T, NW, BKV, HDV, POS><<<grid, NW * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, q_pos, kv_pos, Sq, Skv, H, KV, hd, hdv,
      scale, window, softcap, vec);
  return (int)cudaGetLastError();
}

// (warps, KV tile, widest head dim) by type and head dim; see the note above
template <typename T, bool POS>
int dispatch(const void* q, const void* k, const void* v, void* out, const int* qp,
             const int* kp, int B, int Sq, int Skv, int H, int KV, int hd, int hdv, float scale,
             int window, float softcap, cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int widest = ((hd > hdv ? hd : hdv) + 15) & ~15;
  if (widest <= 64)
    return launch<T, 8, kF32 ? 32 : 64, 64, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd,
                                                 hdv, scale, window, softcap, s);
  if (widest <= 128)
    return launch<T, 8, kF32 ? 32 : 64, 128, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd,
                                                  hdv, scale, window, softcap, s);
  return launch<T, 4, kF32 ? 16 : 32, 256, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd,
                                                hdv, scale, window, softcap, s);
}

template <typename T>
int dispatch_pos(const void* q, const void* k, const void* v, void* out, const int* qp,
                 const int* kp, int B, int Sq, int Skv, int H, int KV, int hd, int hdv,
                 float scale, int window, float softcap, cudaStream_t s) {
  if (qp != nullptr)
    return dispatch<T, true>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                             softcap, s);
  return dispatch<T, false>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                            softcap, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q_pos / kv_pos: int32 positions of the
// query rows and keys, both non-decreasing, or both null for row indices.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out,
                             const int* q_pos, const int* kv_pos, int dtype, int B, int Sq,
                             int Skv, int H, int KV, int hd, int hdv, float scale, int window,
                             float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256 || hdv <= 0 || hdv > 256 || (Sq + 63) / 64 > 65535 ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_pos<float>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv, scale,
                               window, softcap, s);
  if (dtype == 1)
    return dispatch_pos<__nv_bfloat16>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv,
                                       scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
