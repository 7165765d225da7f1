// Fused GAT neighbour attention for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of src/repro/kernels/gat_edge/kernel.py:
//   * gat_aggregate_kernel (_gat_call, pallas_call at :70) — padded layout,
//     rows are the graph's nodes (row_node == nullptr);
//   * bucket_gat_kernel (_bucket_gat_call, pallas_call at :164) — one degree
//     bucket, tile row r holds node row_node[r].
//
// Per (row, head), with node = row_node ? row_node[row] : row:
//   e_j   = LeakyReLU(s_src[node, head] + s_dst[nbr_j, head]), masked slots excluded
//   m     = max_j e_j
//   p_j   = exp(e_j - m) * mask_j,   l = max(sum_j p_j, 1e-30)
//   out[row, head, :] = sum_j (p_j / l) * hw[nbr_j, head, :]      (f32)
//
// Unlike the TPU versions, the kernel gathers the scores and the feature rows
// itself: neither the (H, N, D, F) gathered features of the padded path nor
// the (H, R, W) gathered scores ever exist in device memory.
//
// What bounds it on this card: bytes. Each live slot costs an H*4-byte score
// gather and an H*F*4-byte feature-row gather against ~2HF flops, far below
// the H100's ~20 flop/byte balance point for fp32.
//
// Design: one warp owns a row for all its H heads (or a slice of the row's
// slots, or one head, below), so there are no atomics and any width W works.
// * Slots go in tiles of 32. The lanes read the tile's 32 indices and mask
//   bytes in one coalesced load each, once for all heads; __any_sync of the
//   range check covers every live slot and __ballot_sync picks the live ones.
// * Scores: the lanes take (slot, head) pairs, head fastest, heads padded to
//   HP = the next power of two (<= 32): lane l always holds head l % HP, and
//   32 / HP slots a round, so a round's s_dst gathers read whole H-float rows.
//   Rounds without a live slot are skipped. The max and the sum of a head
//   are shuffle reductions over the lanes of that head. The exp'd scores of
//   the tile sit in a per-warp shared buffer (32 x HP floats), so s_dst is
//   read once.
// * Online softmax over the tiles: a running max and sum per head; the
//   column accumulators are rescaled when the max moves (as flash does).
// * Aggregation: a neighbour row of hw is H x F contiguous floats; lane l
//   owns columns l, l + 32, ... (CH of them a pass), each knowing its head as
//   column / F, so a gather is one coalesced row read. Up to 8 live slots'
//   gathers are issued before their multiply-adds, which run in slot order;
//   a tile's first batch goes out with its score gathers, so a row of up to
//   8 live slots waits on two dependent loads (indices, then scores and
//   features together). The row's (H, F) output is one contiguous store,
//   divided by its head's sum at the end.
// * Small launches: where rows x head blocks come to fewer than 2048 warps
//   (a served batch's 64-row chunks, the cora plan's 136-row bucket), each
//   warp takes one head of a row instead, so the card still has warps enough
//   to hide the loads' latency (a served cora batch, 8 launches, takes
//   0.0235 ms on an H100, chip_smoke.py phase 5; a development build that
//   gave every warp all heads was slower than the 0.0268 ms of the kernel
//   this one replaced, a warp per (row, head)).
// * Wide rows in small buckets: when the warps' tasks number under 4096 and
//   W spans several tiles, a task's tiles are split over up to 8 warps of
//   one block; each part keeps its own (max, sum, accumulators), and the
//   parts meet in shared memory, rescaled to the common max and added in
//   warp order (fixed order, no atomics), so the result is the same from
//   call to call.
// * H > 32: each block of 32 heads is a task of its own. H x F above 32 CH
//   columns runs in passes, each repeating the scores for its heads.
//
// The mask is not assumed to be a prefix (subgraph() leaves holes); padding
// slots hold index 0 and only the mask excludes them. A fully masked row
// gives exactly 0. A live slot (or a row_node) whose index lies outside
// [0, num_nodes) is never dereferenced: that output row is set to NaN.
// exp is the precise expf.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kBatch = 8;              // live slots whose gathers are in flight together
constexpr int kSplitHeadsBelow = 2048;  // below this many row tasks, one head a warp
constexpr int kSplitBelowRows = 4096;  // split a task's slot tiles over warps below this many
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float leaky_relu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// Reduce over the lanes that hold the same head (lanes equal mod HP).
template <int HP>
__device__ __forceinline__ float head_max(float v) {
#pragma unroll
  for (int o = 16; o >= HP; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}
template <int HP>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 16; o >= HP; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Take up to kBatch live slots off `lmask` (lowest first) and issue their
// feature-row gathers: xv[j][k] = hw[row of slot j's index, column c0 + 32 k
// + lane]. Returns how many were taken.
template <int CH>
__device__ __forceinline__ int take_batch(unsigned& lmask, int idx, int (&slot)[kBatch],
                                          float (&xv)[kBatch][CH], const float* __restrict__ hw,
                                          long long hf, int c0, int c_stop, int lane) {
  const int count = min(__popc(lmask), kBatch);
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    slot[j] = j < count ? __ffs(lmask) - 1 : 0;
    if (j < count) lmask &= lmask - 1;
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const long long node = __shfl_sync(kAll, idx, slot[j]);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int col = c0 + k * 32 + lane;
      xv[j][k] = (j < count && col < c_stop) ? __ldg(hw + node * hf + col) : 0.f;
    }
  }
  return count;
}

template <int HP, int CH>  // heads padded (power of two <= 32); columns per lane a pass
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_edge_kernel(const float* __restrict__ hw,            // (N, H, F)
                const float* __restrict__ s_src,         // (N, H)
                const float* __restrict__ s_dst,         // (N, H)
                const int* __restrict__ neighbors,       // (R, W)
                const unsigned char* __restrict__ mask,  // (R, W) bool
                const int* __restrict__ row_node,        // (R,) or nullptr
                float* __restrict__ out,                 // (R, H, F)
                long long rows, int width, int heads, int feat, long long num_nodes,
                float negative_slope, int head_block, int head_blocks, int split,
                int tasks_per_block, int tiles_per_part) {
  constexpr int SPR = 32 / HP;  // slots a round of (slot, head) pairs
  constexpr unsigned kRoundBits = (unsigned)((1ull << SPR) - 1ull);  // a round's slots
  __shared__ float pbuf[kMaxWarps][32 * HP];  // the tile's exp'd scores, (slot, head)
  __shared__ float part_acc[kMaxWarps][32 * CH];
  __shared__ float part_m[kMaxWarps][HP], part_l[kMaxWarps][HP];
  __shared__ int part_bad[kMaxWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp % split;
  // this warp's task: (row, block of head_block heads), or a slice of its tiles
  const long long task = (long long)blockIdx.x * tasks_per_block + warp / split;
  const bool active = task < rows * head_blocks;
  const long long row = active ? task / head_blocks : 0;
  const int h0 = active ? (int)(task % head_blocks) * head_block : 0;
  const int ntiles = (width + 31) / 32;
  const int t_begin = part * tiles_per_part;
  const int t_end = min(ntiles, t_begin + tiles_per_part);
  const long long hf = (long long)heads * feat;
  const int* nbr_row = neighbors + row * width;
  const unsigned char* mask_row = mask + row * width;
  const long long node = !active ? 0 : row_node != nullptr ? (long long)row_node[row] : row;
  const bool node_bad = active && (node < 0 || node >= num_nodes);
  float* pb = pbuf[warp];
  const int ph = lane % HP;  // the head of this lane's (slot, head) pairs

  const int nhb = min(head_block, heads - h0);  // heads in this block
  const bool ph_ok = ph < nhb;
  const float s_self = (active && !node_bad && ph_ok) ? s_src[node * heads + h0 + ph] : 0.f;
  const int c_stop = (h0 + nhb) * feat;
  // every warp of a block makes as many passes as a full head block needs,
  // so a short last head block (H > 32) keeps the split's barriers aligned
  const int passes = (head_block * feat + 32 * CH - 1) / (32 * CH);
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = h0 * feat + pass * 32 * CH;
    int chead[CH];  // block-relative head of each of this lane's columns
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int col = c0 + k * 32 + lane;
      chead[k] = col < c_stop ? col / feat - h0 : 0;
    }
    float acc[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) acc[k] = 0.f;
    float m = -CUDART_INF_F, l = 0.f;  // running max and sum of head ph
    bool bad = node_bad;

    if (active && !bad) {
      for (int ti = t_begin; ti < t_end; ++ti) {
        const int w = ti * 32 + lane;
        const int idx = w < width ? __ldg(nbr_row + w) : 0;
        const bool live = w < width && __ldg(mask_row + w) != 0;
        if (__any_sync(kAll, live && (idx < 0 || (long long)idx >= num_nodes))) {
          bad = true;
          break;
        }
        const unsigned tile_live = __ballot_sync(kAll, live);
        if (tile_live == 0u) continue;

        // the first batch's feature gathers go out with the score gathers
        unsigned lmask = tile_live;
        int slot[kBatch];
        float xv[kBatch][CH];
        int count = take_batch(lmask, idx, slot, xv, hw, hf, c0, c_stop, lane);

        // scores of the tile's (slot, head) pairs: pair r * 32 + lane is
        // (slot r * SPR + lane / HP, head ph)
        float tmax = -CUDART_INF_F;
        __syncwarp();  // the previous tile's buffer has been read
#pragma unroll
        for (int r = 0; r < HP; ++r) {
          if ((tile_live >> (r * SPR)) & kRoundBits) {
            const int k = r * SPR + lane / HP;
            const int nb = __shfl_sync(kAll, idx, k);
            float e = -CUDART_INF_F;
            if (((tile_live >> k) & 1u) && ph_ok)
              e = leaky_relu(s_self + __ldg(s_dst + (long long)nb * heads + h0 + ph),
                             negative_slope);
            pb[r * 32 + lane] = e;
            tmax = fmaxf(tmax, e);
          } else {
            pb[r * 32 + lane] = -CUDART_INF_F;
          }
        }
        tmax = head_max<HP>(tmax);
        const float m_new = fmaxf(m, tmax);
        const float corr = m_new == -CUDART_INF_F ? 1.f : expf(m - m_new);
        m = m_new;
        float psum = 0.f;
#pragma unroll
        for (int r = 0; r < HP; ++r) {
          const float e = pb[r * 32 + lane];
          const float p = e == -CUDART_INF_F ? 0.f : expf(e - m);
          pb[r * 32 + lane] = p;
          psum += p;
        }
        l = l * corr + head_sum<HP>(psum);
#pragma unroll
        for (int k = 0; k < CH; ++k) acc[k] *= __shfl_sync(kAll, corr, chead[k]);
        __syncwarp();  // the exp'd scores are visible to the whole warp

        while (true) {  // the batch's multiply-adds in slot order, then the next batch
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j < count) {
#pragma unroll
              for (int k = 0; k < CH; ++k)
                acc[k] = fmaf(pb[slot[j] * HP + chead[k]], xv[j][k], acc[k]);
            }
          }
          if (lmask == 0u) break;
          count = take_batch(lmask, idx, slot, xv, hw, hf, c0, c_stop, lane);
        }
      }
    }

    if (split == 1) {
      if (active) {
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const float den = fmaxf(__shfl_sync(kAll, l, chead[k]), 1e-30f);
          const int col = c0 + k * 32 + lane;
          if (col < c_stop) out[row * hf + col] = bad ? CUDART_NAN_F : acc[k] / den;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < CH; ++k) part_acc[warp][k * 32 + lane] = acc[k];
      if (lane < HP) {
        part_m[warp][lane] = m;
        part_l[warp][lane] = l;
      }
      if (lane == 0) part_bad[warp] = bad;
      __syncthreads();
      if (active && part == 0) {
        bool row_bad = false;
        for (int q = 0; q < split; ++q) row_bad |= part_bad[warp + q] != 0;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int hd = chead[k];
          float mx = -CUDART_INF_F;
          for (int q = 0; q < split; ++q) mx = fmaxf(mx, part_m[warp + q][hd]);
          float sum = 0.f, den = 0.f;
          for (int q = 0; q < split; ++q) {
            const float pm = part_m[warp + q][hd];
            const float sc = pm == -CUDART_INF_F ? 0.f : expf(pm - mx);
            sum += part_acc[warp + q][k * 32 + lane] * sc;
            den += part_l[warp + q][hd] * sc;
          }
          const int col = c0 + k * 32 + lane;
          if (col < c_stop)
            out[row * hf + col] = row_bad ? CUDART_NAN_F : sum / fmaxf(den, 1e-30f);
        }
      }
      __syncthreads();  // the partials are read before the next pass writes them
    }
  }
}

template <int HP, int CH>
int launch(const float* hw, const float* s_src, const float* s_dst, const int* neighbors,
           const unsigned char* mask, const int* row_node, float* out, long long rows,
           int width, int heads, int feat, long long num_nodes, float slope, int head_block,
           cudaStream_t stream) {
  const int head_blocks = (heads + head_block - 1) / head_block;
  const long long tasks = rows * head_blocks;
  const int ntiles = (width + 31) / 32;
  const int split =
      (tasks < kSplitBelowRows && ntiles > 1) ? (ntiles < kMaxWarps ? ntiles : kMaxWarps) : 1;
  const int tasks_per_block = kMaxWarps / split;
  const int tiles_per_part = (ntiles + split - 1) / split;
  const long long blocks = (tasks + tasks_per_block - 1) / tasks_per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  gat_edge_kernel<HP, CH><<<(unsigned)blocks, tasks_per_block * split * 32, 0, stream>>>(
      hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads, feat, num_nodes,
      slope, head_block, head_blocks, split, tasks_per_block, tiles_per_part);
  return (int)cudaGetLastError();
}

template <int HP>
int by_columns(const float* hw, const float* s_src, const float* s_dst, const int* neighbors,
               const unsigned char* mask, const int* row_node, float* out, long long rows,
               int width, int heads, int feat, long long num_nodes, float slope, int head_block,
               cudaStream_t s) {
  const long long cols = (long long)head_block * feat;  // one head block's columns
  if (cols <= 32)
    return launch<HP, 1>(hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads,
                         feat, num_nodes, slope, head_block, s);
  if (cols <= 64)
    return launch<HP, 2>(hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads,
                         feat, num_nodes, slope, head_block, s);
  return launch<HP, 4>(hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads,
                       feat, num_nodes, slope, head_block, s);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int gat_edge_forward(const float* hw, const float* s_src, const float* s_dst,
                                const int* neighbors, const unsigned char* mask,
                                const int* row_node, float* out, long long rows,
                                int width, int heads, int feat, long long num_nodes,
                                float negative_slope, void* stream) {
  if (rows <= 0 || heads <= 0 || feat <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // a warp takes all the heads of a row (at most 32), or one head where that
  // leaves too few warps to fill the card
  int head_block = heads < 32 ? heads : 32;
  if (rows * ((heads + head_block - 1) / head_block) < kSplitHeadsBelow) head_block = 1;
#define GAT_BY_HEADS(HP)                                                                  \
  return by_columns<HP>(hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads, \
                        feat, num_nodes, negative_slope, head_block, s)
  if (head_block <= 1) GAT_BY_HEADS(1);
  if (head_block <= 2) GAT_BY_HEADS(2);
  if (head_block <= 4) GAT_BY_HEADS(4);
  if (head_block <= 8) GAT_BY_HEADS(8);
  if (head_block <= 16) GAT_BY_HEADS(16);
  GAT_BY_HEADS(32);
#undef GAT_BY_HEADS
}
