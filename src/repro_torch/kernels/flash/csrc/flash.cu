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
// Two designs, picked per launch by the wrapper (kernel.py `route`) and
// passed in as flash_forward's `route`: fp32 always, and bf16 where TMA
// cannot describe the tensors (hd or hd_v not a multiple of 8, or a base off
// 16-byte alignment), run FlashAttention-2 style on warp-level mma.sync;
// every other bf16 launch runs on Hopper's warpgroup MMAs fed by TMA.
//
// ------------------------------------------------ fp32 (and odd bf16) --
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
//   bf16 inputs here run bf16 MMAs (m16n8k16) for S, and P.V from P split
//   into two bf16 parts as the wgmma instances below do it.
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
// * Why fp32 stays on mma.sync: wgmma TF32 needs both operands K-major in
//   shared memory, so V would be transposed on its way in, and its operands
//   come from shared memory, so the split tiles of Q, K and V would all
//   live there (Q alone is 135 KB split at 128 rows x hd 128). mma.sync
//   takes Q and P split in registers.
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
//
// ----------------------------------------------------------- bf16 on wgmma --
// What bounds it: the bytes at the serving prefill's shape (67 MB at 3.35
// TB/s = 0.020 ms, against 8.67e9 operations at 989 TFLOP/s = 0.0088 ms;
// the P split below makes P.V two products, 1.5x the tensor work). What
// holds it back is instruction count and latency, not the tensor cores:
// timing each phase of a tile with clock64 in a copy of this kernel found
// the softmax taking most of a tile's cycles while its per-element
// branches (softcap, mask) each held an IEEE division; hoisted out of the
// element loops, the softmax still takes the largest share, then S's wait.
// * Block: 128 query rows of one (b, h) = two consumer warpgroups of 64
//   rows, then one producer warpgroup (384 threads) of which one warp
//   starts every copy. setmaxnreg moves registers from the producer to the
//   consumers, but ptxas allocates the whole kernel within the launch
//   bound's 168 registers a thread (the consumers use none above it), so
//   the consumer state is sized to fit 168.
// * Loads: TMA (cp.async.bulk.tensor) through tensor maps of the model's
//   (B, S, heads, dim) tensors as they lie (4-d, boxes of 64 columns x 1
//   head x 64 rows, 128-byte swizzle), so hd is split into 64-wide boxes,
//   and TMA's zero fill pads hd 112 and 192 and the ragged Skv and Sq edges.
//   Q comes once (its own mbarrier); K, V and, with positions, the tile's
//   key positions (a 1-d map) come through a ring of 3 stages (2 at hd_v >
//   128) with full and empty mbarriers: the producer waits for both
//   consumers' 8 warps to release a stage before refilling it. The maps are
//   __grid_constant__ parameters; cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library links no libcuda.
// * S = Q.K^T: wgmma m64n64k16, Q (A) and K (B) K-major in the swizzled
//   boxes, fp32 accumulator; the first k-step writes S without reading it.
// * P.V keeps P fp32-accurate, as the TPU kernel multiplies P in fp32: each
//   p is split into its bf16 high part and the bf16 rounding of the rest
//   (split_bf16, p = hi + lo to ~2^-17 of p), and two register-A wgmma
//   products m64n{64,128}k16, lo.V then hi.V, accumulate into O in fp32,
//   with V read MN-major (the transpose bit) from the same stage. P rounded
//   to bf16 once misses the plain version by many bf16 ulps
//   (tests/test_torch_flash.py emulates both).
// * Overlap: tile it's S is started, then tile it - 1's P.V behind it; the
//   softmax of tile it runs while that P.V multiplies, and the stage of
//   tile it - 1 is released once its P.V is waited on. P goes to its own
//   registers: writing S (a wgmma accumulator) before the P.V started after
//   it completes makes ptxas serialize every wgmma in the kernel, as does a
//   wgmma under a branch the compiler cannot prove warp-uniform, so the
//   warpgroup index and every such branch value come from a shuffle, and
//   each warpgroup's tiles are one run [first, last) with no wgmma inside
//   a data-dependent branch. Two warpgroups taking turns at their products
//   (FlashAttention-3's ping-pong) measured no gain and is not done.
// * Softmax: the mma.sync instance's arithmetic, expression for expression
//   (x = s scale, softcap tanh(x / softcap), p = __expf(x - m) on
//   ex2.approx, a masked p = 0 exactly, O / max(l, 1e-30)), so the two
//   instances differ only in how the tensor cores sum (scores in log2
//   units and a reciprocal for the division ran faster, but moved a 64-layer
//   bf16 prefill's logits past their limit from the fp32 step; PERF.md §6);
//   the branches on softcap and on a tile that masks nothing are taken
//   once a tile, not once an element; O's rescale is skipped when no row
//   max of the warp moved.
// * Masking, the window, GQA, positions and the heaviest-tiles-first grid
//   as above; a warpgroup whose rows see none of a tile's keys only waits
//   for it and releases it. The same shapes give the same bits on relaunch.
// * Epilogue: O / max(l, 1e-30), each quotient from the denominator's
//   reciprocal and one fma correction (the division's result, without an
//   IEEE division an element), in bf16 into the warpgroup's Q buffer in the
//   128-byte swizzle, then one TMA store a 64-column box; TMA drops the
//   rows past Sq and the columns past hd_v.
// * GQA rows are not packed (the query heads sharing a K/V head are separate
//   blocks); their K/V tiles come from L2 for all but the first.
//
// Instances (HDV = hd_v rounded up to 64, 128 or 256; hd <= 256 at run
// time), BKV 64, shared memory = 1 KB (alignment) + 8 KB x (2 max(nqb,
// NVB) + NS (nqb + NVB)) + NS x 256 B with positions + barriers, nqb =
// ceil(hd / 64), NVB = HDV / 64; -Xptxas -v, nvcc 12.9:
//   HDV 64:  hd 64: 66,616 B; 168 registers, no spills
//   HDV 128: hd 128 or 112: 132,152 B; hd 192 (MLA): 173,112 B; 168, none
//   HDV 256: hd 256: 197,672 B; 168 registers, ~2.8 KB spilled, and ptxas
//            serializes its wgmmas (too few registers for O's 128 a thread)
// flash.cu builds in 52 s with its 18 instances (25-31 s before the wgmma
// ones), beside the other three libraries in the smoke's parallel build.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
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


// ------------------------------------------------------ bf16 wgmma route --
// (the design note at the top: "bf16 on wgmma")

constexpr int WG_ROWS = 64;        // query rows of one consumer warpgroup
constexpr int WBQ = 2 * WG_ROWS;   // query rows of a block
constexpr int WBKV = 64;           // keys of a K/V tile
constexpr int WTHREADS = 3 * 128;  // two consumer warpgroups, then the producer's
constexpr int BOX_BYTES = 64 * 128;  // one TMA box: 64 rows of 64 bf16 columns (128 B)
constexpr uint64_t kWaitLimitNs = 10000000000ull;  // 10 s

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` of TMA transfers to complete the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait until the phase of parity `parity` has completed; a wait of more
// than kWaitLimitNs is a fault, and traps (a launch error, not a hang)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      const uint64_t now = global_ns();
      if (start == 0)
        start = now;
      else if (now - start > kWaitLimitNs)
        __trap();
    }
  }
}

// TMA: box (c0, c1, c2, c3) of a 4-d map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load1(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}
// TMA: shared memory into box (c0, c1, c2, c3) of a 4-d map (parts outside it are dropped)
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled tile (a TMA box
// written with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte-aligned address):
// lbo, sbo in bytes (K-major: sbo the 8-row stride, lbo unused; MN-major:
// lbo the stride between 64-column blocks, sbo between 8-row groups of K)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across its start and its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, fp32) += A . B^T: A (64 x 16) and B (64 x 16), both K-major
// in shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) = A . B^T, D written only: the first k-step of S
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// O (64 x 64, fp32) += P . V: P (64 x 16) from registers (the accumulator
// layout's fragment), V (16 x 64) MN-major in shared memory (descriptor db)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, fp32) += P . V, as above with 128 columns
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The block's KV tiles: [kv_begin, kv_begin + ntiles WBKV), the keys its last
// row sees, from its first row's window on (the same in every warp).
struct TileRange {
  int kv_begin, kv_end, ntiles;
};
template <bool POS>
__device__ __forceinline__ TileRange tile_range(const int* q_pos, const int* kv_pos, int q0,
                                                int Sq, int Skv, int window) {
  TileRange r;
  r.kv_begin = 0;
  if constexpr (POS) {
    r.kv_end = warp_upper_bound(kv_pos, Skv, q_pos[min(q0 + WBQ, Sq) - 1]);
    if (window > 0)
      r.kv_begin = (warp_upper_bound(kv_pos, Skv, q_pos[q0] - window) / WBKV) * WBKV;
  } else {
    r.kv_end = min(Skv, q0 + WBQ);
    if (window > 0 && q0 - window + 1 > 0) r.kv_begin = ((q0 - window + 1) / WBKV) * WBKV;
  }
  r.ntiles = r.kv_end > r.kv_begin ? (r.kv_end - r.kv_begin + WBKV - 1) / WBKV : 0;
  return r;
}

// bf16 on wgmma. HDV: hd_v rounded up to 64, 128 or 256; hd (<= 256) is a
// runtime value. POS: mask by q_pos / kv_pos (each tile's key positions come
// in with its K tile).
template <int HDV, bool POS>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,   // q   (B, Sq, H, hd)
                   const __grid_constant__ CUtensorMap tk,   // k   (B, Skv, KV, hd)
                   const __grid_constant__ CUtensorMap tv,   // v   (B, Skv, KV, hd_v)
                   const __grid_constant__ CUtensorMap to,   // out (B, Sq, H, hd_v)
                   const __grid_constant__ CUtensorMap tkp,  // kv_pos (Skv,), POS only
                   const int* __restrict__ q_pos, const int* __restrict__ kv_pos, int Sq,
                   int Skv, int H, int KV, int hd, float scale, int window, float softcap) {
  constexpr int NS = HDV > 128 ? 2 : 3;      // ring stages
  constexpr int PW = HDV < 128 ? HDV : 128;  // output columns of one P.V product
  constexpr int NP = HDV / PW;               // P.V products a k-step
  constexpr int NVB = HDV / 64;              // V boxes a tile
  constexpr int NT = WBKV / 8;               // 8-key column groups of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // rounded up to 1024 bytes, the 128-byte swizzle pattern's period
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int nqb = (hd + 63) / 64;              // Q and K boxes a row block
  const int qreg = max(nqb, NVB) * BOX_BYTES;  // a warpgroup's Q tile, then its O tile
  const uint32_t sQ = base;                    // 2 x qreg
  const uint32_t sK = sQ + 2 * qreg;           // NS x nqb boxes
  const uint32_t sV = sK + NS * nqb * BOX_BYTES;  // NS x NVB boxes
  const uint32_t sKp = sV + NS * NVB * BOX_BYTES;  // POS: NS x WBKV key positions
  const uint32_t bars = sKp + (POS ? NS * WBKV * 4 : 0);
  const uint32_t qbar = bars + 16 * NS;  // full[s] at bars + 8 s, empty[s] at bars + 8 (NS + s)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WBQ;  // heaviest causal tiles first
  // warp-uniform for the compiler (a shuffle's result), as is every value
  // that decides whether a warpgroup starts a wgmma: otherwise it fences
  // each wgmma on its own and they run one after another
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);         // full: the producer's arrival and the bytes
      mbar_init(bars + 8 * (NS + s), 8);  // empty: each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != 8) return;
    if ((threadIdx.x & 31) == 0) {
      for (const CUtensorMap* map : {&tq, &tk, &tv, &to}) {
        const uint64_t addr = reinterpret_cast<uint64_t>(map);
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(addr) : "memory");
      }
      mbar_expect_tx(qbar, 2 * nqb * BOX_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < nqb; ++c)
          tma_load4(sQ + w * qreg + c * BOX_BYTES, &tq, qbar, c * 64, h, q0 + w * WG_ROWS, b);
    }
    const TileRange r = tile_range<POS>(q_pos, kv_pos, q0, Sq, Skv, window);
    if ((threadIdx.x & 31) != 0) return;
    const uint32_t tile_bytes = (nqb + NVB) * BOX_BYTES + (POS ? WBKV * 4 : 0);
    for (int it = 0; it < r.ntiles; ++it) {
      const int s = it % NS, k0 = r.kv_begin + it * WBKV;
      if (it >= NS) mbar_wait(bars + 8 * (NS + s), ((it / NS) - 1) & 1);  // both consumers done
      const uint32_t full = bars + 8 * s;
      mbar_expect_tx(full, tile_bytes);
      for (int c = 0; c < nqb; ++c)
        tma_load4(sK + (s * nqb + c) * BOX_BYTES, &tk, full, c * 64, kvh, k0, b);
      for (int c = 0; c < NVB; ++c)
        tma_load4(sV + (s * NVB + c) * BOX_BYTES, &tv, full, c * 64, kvh, k0, b);
      if constexpr (POS) tma_load1(sKp + s * WBKV * 4, &tkp, full, k0);
    }
  } else {
    // ----------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wg_lo = q0 + wg * WG_ROWS, wg_hi = wg_lo + WG_ROWS - 1;
    const int row_lo = wg_lo + warp * 16, row_hi = row_lo + 15;
    const TileRange r = tile_range<POS>(q_pos, kv_pos, q0, Sq, Skv, window);
    // The warpgroup's tiles [first, last): the keys its rows see are one run,
    // from the window of its first row to its last row. The tiles outside it
    // are only waited for and released. POS: the warp's first and last
    // rows' positions and this thread's two rows'.
    int first = 0, last = 0, qw_lo = 0, qw_hi = 0, qp[2] = {0, 0};
    if constexpr (POS) {
      const int wg_end = warp_upper_bound(kv_pos, Skv, q_pos[min(wg_hi, Sq - 1)]);
      last = (wg_end - r.kv_begin + WBKV - 1) / WBKV;
      if (window > 0) {
        // the first key within the window of the warpgroup's first row
        const int j0 = warp_upper_bound(kv_pos, Skv, q_pos[min(wg_lo, Sq - 1)] - window);
        first = j0 > r.kv_begin ? (j0 - r.kv_begin) / WBKV : 0;
      }
      qw_lo = q_pos[min(row_lo, Sq - 1)];
      qw_hi = q_pos[min(row_hi, Sq - 1)];
      qp[0] = q_pos[min(row_lo + g, Sq - 1)];
      qp[1] = q_pos[min(row_lo + g + 8, Sq - 1)];
    } else {
      last = wg_hi >= r.kv_begin ? (wg_hi - r.kv_begin) / WBKV + 1 : 0;
      const int key_lo = wg_lo - window + 1;  // window: the first key any of its rows sees
      if (window > 0 && key_lo > r.kv_begin) first = (key_lo - r.kv_begin) / WBKV;
    }
    if (wg_lo >= Sq) last = 0;
    first = __shfl_sync(0xffffffffu, min(first, r.ntiles), 0);
    last = __shfl_sync(0xffffffffu, max(first, min(last, r.ntiles)), 0);
    const unsigned char* sbase = smem_raw + (base - raw);

    float o[NP][PW / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) o[p][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const uint32_t myQ = sQ + wg * qreg;
    const int nk = (hd + 15) / 16;  // 16-wide k-steps of S
    // P of the tile before, whose P.V is started behind the next tile's S (so
    // the softmax runs while the tensor cores multiply), as a high and a low
    // part (split_bf16), k-step kk's A fragment at [kk]; its stage
    uint32_t ph[NT / 2][4], pl[NT / 2][4];
    int pend_stage = 0;
    float sc[NT * 4];  // S of this tile

    // P.V's registers, fixed before a fence and after the wait that
    // completes it (S's after its own wait): their other uses stay on the
    // right side of both. A use the compiler moved across makes it fence and
    // serialize every wgmma; so does pinning a register of a wgmma still
    // running, or writing S before the P.V started behind it is done.
    auto pin_pv = [&]() {
#pragma unroll
      for (int p = 0; p < NP; ++p) pin(o[p]);
      pin(ph);
      pin(pl);
    };
    // O += lo.V then hi.V for the tile before; keys past the warpgroup's
    // last row carry p = 0
    auto start_pv = [&]() {
      const uint32_t vs = sV + pend_stage * NVB * BOX_BYTES;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t dv = sw128_desc(vs + 2 * p * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024);
          wgmma_rs(o[p], pl[kk], dv);
          wgmma_rs(o[p], ph[kk], dv);
        }
    };
    // this warp is done with stage st
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (NS + st));
    };
    auto pass = [&](int it) {  // a tile none of the warpgroup's rows sees
      mbar_wait(bars + 8 * (it % NS), (it / NS) & 1);
      release(it % NS);
    };
    // tile it: S, (the tile before's P.V,) mask and online softmax, O
    // rescaled, P split for its own P.V
    auto tile = [&](int it, auto has_prev) {
      constexpr bool PREV = decltype(has_prev)::value;
      const int s = it % NS, k0 = r.kv_begin + it * WBKV;
      mbar_wait(bars + 8 * s, (it / NS) & 1);
      [[maybe_unused]] const int* kp =
          reinterpret_cast<const int*>(sbase + (sKp - base) + s * WBKV * 4);
      pin_pv();
      wgmma_fence();
      const uint32_t ks = sK + s * nqb * BOX_BYTES;
      wgmma_ss_n64_first(sc, sw128_desc(myQ, 16, 1024), sw128_desc(ks, 16, 1024));
      for (int kk = 1; kk < nk; ++kk) {
        const int off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
        wgmma_ss_n64(sc, sw128_desc(myQ + off, 16, 1024), sw128_desc(ks + off, 16, 1024));
      }
      wgmma_commit();
      if constexpr (PREV) {
        start_pv();
        wgmma_commit();
        wgmma_wait<1>();  // S; P.V may still run, and O, P stay its own until its wait
        pin(sc);
      } else {
        wgmma_wait<0>();
        pin(sc);
      }

      // thread holds rows row_lo + g (c = 0, 1) and + 8 (c = 2, 3), keys
      // k0 + 8 j + 2 t + (c & 1), at sc[4 j + c]. The scores (s scale,
      // through the softcap), then P, go to pp, in the mma.sync instance's
      // arithmetic expression for expression; S stays the S product's own
      // until the tile before's P.V is done.
      float pp[NT * 4];
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) pp[e] = softcap * tanhf(sc[e] * scale / softcap);
      } else {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) pp[e] = sc[e] * scale;
      }
      bool full;  // no key of the tile is masked for the warp's rows
      if constexpr (POS)
        full = k0 + WBKV <= Skv && kp[WBKV - 1] <= qw_lo &&
               (window <= 0 || qw_hi - kp[0] < window);
      else
        full = k0 + WBKV - 1 <= row_lo && k0 + WBKV <= Skv &&
               (window <= 0 || row_hi - k0 < window);
      uint32_t okbits = 0xffffffffu;
      if (!full) {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) {
          const int c = e & 3, kl = (e >> 2) * 8 + 2 * t + (c & 1);
          bool ok;
          if constexpr (POS) {
            const int qpos = qp[c >> 1], kpos = kp[kl];
            ok = k0 + kl < Skv && kpos <= qpos && (window <= 0 || qpos - kpos < window);
          } else {
            const int row = row_lo + g + (c >> 1) * 8, key = k0 + kl;
            ok = key < Skv && key <= row && (window <= 0 || row - key < window);
          }
          if (!ok) {
            okbits &= ~(1u << e);
            pp[e] = kNeg;
          }
        }
      }
      float mx[2] = {kNeg, kNeg}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], pp[e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
      }
      if (full) {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) {
          pp[e] = __expf(pp[e] - m[(e >> 1) & 1]);
          rs[(e >> 1) & 1] += pp[e];
        }
      } else {  // a masked p is 0 exactly, whatever the row's max so far
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) {
          pp[e] = (okbits >> e) & 1u ? __expf(pp[e] - m[(e >> 1) & 1]) : 0.f;
          rs[(e >> 1) & 1] += pp[e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * corr[i] + rs[i];
      }
      if constexpr (PREV) {  // the tile before's P.V is done with O, P and its stage
        wgmma_wait<0>();
        pin_pv();
        release(pend_stage);
      }
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < PW / 2; i += 4) {
            o[p][i] *= corr[0];
            o[p][i + 1] *= corr[0];
            o[p][i + 2] *= corr[1];
            o[p][i + 3] *= corr[1];
          }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        split_bf16(pp[8 * kk + 0], pp[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(pp[8 * kk + 2], pp[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split_bf16(pp[8 * kk + 4], pp[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split_bf16(pp[8 * kk + 6], pp[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
      pend_stage = s;
    };

    mbar_wait(qbar, 0);
    for (int it = 0; it < first; ++it) pass(it);
    if (last > first) {
      tile(first, Flag<false>{});
      for (int it = first + 1; it < last; ++it) tile(it, Flag<true>{});
    }
    for (int it = last; it < r.ntiles; ++it) pass(it);
    if (last > first) {  // the last tile's P.V
      pin_pv();
      wgmma_fence();
      start_pv();
      wgmma_commit();
      wgmma_wait<0>();
      pin_pv();
      release(pend_stage);
    }

    // ------------------------------------------------------------ epilogue --
    // O / max(l, 1e-30) in bf16 into this warpgroup's Q tile (its last S
    // product has completed), in the 128-byte swizzle, then one TMA store a
    // 64-column box (rows past Sq and columns past hd_v are dropped)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // x / den correctly rounded, as a division gives it, from den's
      // correctly rounded reciprocal and one fma correction (Markstein),
      // not one IEEE division an element
      const float den = fmaxf(l[i], 1e-30f), rcp = 1.f / den;
      auto quotient = [&](float x) {
        const float q = __fmul_rn(x, rcp);
        return fmaf(fmaf(-q, den, x), rcp, q);
      };
      const int row = warp * 16 + g + 8 * i;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PW / 8; ++j) {
          const int col = p * PW + 8 * j;
          const uint32_t addr = myQ + (col / 64) * BOX_BYTES + row * 128 +
                                ((((col % 64) / 8) ^ (row & 7)) << 4) + 4 * t;
          const uint32_t v =
              pack_bf16(quotient(o[p][4 * j + 2 * i]), quotient(o[p][4 * j + 2 * i + 1]));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's stores
    if ((threadIdx.x & 127) == 0 && wg_lo < Sq) {
      for (int c = 0; c < NVB; ++c) tma_store4(&to, myQ + c * BOX_BYTES, c * 64, h, wg_lo, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, S, heads, dim) bf16 tensor, read in place: boxes of 64
// columns (128 B, swizzled) x 1 head x `rows` rows x 1 batch row; reads
// past dim or S fill with 0.
bool bshd_map(CUtensorMap* map, const void* p, int B, int S, int heads, int dim, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * dim, 2ull * dim * heads, 2ull * dim * heads * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
// key positions (Skv,) int32, WBKV a box
bool pos_map(CUtensorMap* map, const int* p, int n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unread at rank 1
  const cuuint32_t box[1] = {WBKV};
  const cuuint32_t unit[1] = {1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<int*>(p), dims, strides, box,
                   unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HDV, bool POS>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const int* q_pos,
                 const int* kv_pos, int B, int Sq, int Skv, int H, int KV, int hd, int hdv,
                 float scale, int window, float softcap, cudaStream_t stream) {
  constexpr int NS = HDV > 128 ? 2 : 3, NVB = HDV / 64;
  const int nqb = (hd + 63) / 64;
  const size_t smem = 1024 + (size_t)BOX_BYTES * (2 * (nqb > NVB ? nqb : NVB) + NS * (nqb + NVB)) +
                      (POS ? NS * WBKV * 4 : 0) + 8 * (2 * NS + 1);
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to, tkp = {};
  if (!bshd_map(&tq, q, B, Sq, H, hd, WG_ROWS) || !bshd_map(&tk, k, B, Skv, KV, hd, WBKV) ||
      !bshd_map(&tv, v, B, Skv, KV, hdv, WBKV) || !bshd_map(&to, out, B, Sq, H, hdv, WG_ROWS) ||
      (POS && !pos_map(&tkp, kv_pos, Skv)))
    return (int)cudaErrorInvalidValue;
  static size_t opted = 0;  // dynamic shared memory this instantiation may use
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HDV, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + WBQ - 1) / WBQ));
  flash_wgmma_kernel<HDV, POS><<<grid, WTHREADS, smem, stream>>>(
      tq, tk, tv, to, tkp, q_pos, kv_pos, Sq, Skv, H, KV, hd, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <bool POS>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* out, const int* qp,
                   const int* kp, int B, int Sq, int Skv, int H, int KV, int hd, int hdv,
                   float scale, int window, float softcap, cudaStream_t s) {
  if (hdv <= 64)
    return launch_wgmma<64, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                                 softcap, s);
  if (hdv <= 128)
    return launch_wgmma<128, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                                  softcap, s);
  return launch_wgmma<256, POS>(q, k, v, out, qp, kp, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                                softcap, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q_pos / kv_pos: int32 positions of the
// query rows and keys, both non-decreasing, or both null for row indices.
// route: 0 = the mma.sync instances (fp32, or bf16 where TMA cannot take the
// tensors), 1 = the bf16 wgmma instances, which take bf16 with hd and hd_v
// multiples of 8 and q, k, v, out, kv_pos 16-byte aligned (anything else is
// cudaErrorInvalidValue). Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out,
                             const int* q_pos, const int* kv_pos, int dtype, int B, int Sq,
                             int Skv, int H, int KV, int hd, int hdv, float scale, int window,
                             float softcap, int route, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256 || hdv <= 0 || hdv > 256 || (Sq + 63) / 64 > 65535 ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
                            (uintptr_t)kv_pos;
    if (dtype != 1 || hd % 8 != 0 || hdv % 8 != 0 || (bases & 15) != 0)
      return (int)cudaErrorInvalidValue;
    if (q_pos != nullptr)
      return dispatch_wgmma<true>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv, scale,
                                  window, softcap, s);
    return dispatch_wgmma<false>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv, scale,
                                 window, softcap, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_pos<float>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv, scale,
                               window, softcap, s);
  if (dtype == 1)
    return dispatch_pos<__nv_bfloat16>(q, k, v, out, q_pos, kv_pos, B, Sq, Skv, H, KV, hd, hdv,
                                       scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
