// Padded-neighbor SpMM (GCN aggregation) for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of src/repro/kernels/spmm/kernel.py, which
// share one pallas_call (_spmm_call, :77):
//   * padded_spmm_kernel (:86) — the square padded layout, R = N;
//   * bucket_spmm_kernel (:99) — one degree bucket's (R, W) tile indexing
//     into the full (N, F) feature matrix, R != N.
// One kernel serves both: a row of `neighbors` names the feature rows it
// sums, whatever R is.
//
// Per output row r (what the Pallas body, kernel.py:32-49, computes):
//   out[r, :] = sum_{w < W} norm[r, w] * hw[nbr[r, w], :]        (f32)
// There is no mask: padding slots carry norm 0 and index 0. A slot whose
// norm is 0 adds exactly 0 for finite features, so the kernel skips it; a
// row whose norms are all 0 comes out exactly 0. Every slot's index is
// range-checked, padding slots included: a slot whose index lies outside
// [0, N) is never dereferenced, and that output row is set to NaN.
//
// What bounds it on this card: bytes. Each slot costs a 4-byte index and a
// 4-byte norm; each live slot adds an F*4-byte feature-row gather for 2F
// flops, far below the H100's ~20 flop/byte fp32 balance point. On the
// training path the slots are mostly padding (skewed-powerlaw padded to W
// 129: 92% of the GCN chunks' slots), so the bound is the padded index and
// norm arrays, read once.
//
// Design:
// * One warp owns a row, or a slice of it (below). The lanes read 32
//   consecutive slots' indices and norms in one coalesced load each (the
//   next 32 slots are loaded while these are summed); __any_sync of the
//   range check covers every slot, and __ballot_sync of norm != 0 picks the
//   live ones.
// * Gathers in flight: up to 8 live (index, norm) pairs are broadcast with
//   __shfl_sync, all their feature-row loads are issued (lane = column, so
//   each gather is one coalesced row read; a lane walks columns lane,
//   lane + 32, ... for F > 32), and only then are they multiply-added, in
//   slot order, into one accumulator per column. A warp's sum is a plain
//   slot walk's order without the zero-norm slots.
// * Wide rows in small buckets: when R is small (under 4096 rows) and W
//   spans several 32-slot groups, the groups of a row are split over up to 8
//   warps of one block; the partial sums meet in shared memory and are added
//   in warp order (fixed order, no atomics), so the result is deterministic.
// * Registers and shared memory (-Xptxas -v): no dynamic shared memory;
//   static partial sums of 8 warps x 32 CH columns (1,056 B at CH 1, 8,224 B
//   at CH 8, flags included); 32 registers at CH 1 (F <= 32, the training
//   path's F 32 and 16), so 8 blocks of 256 threads (64 warps) an SM; 48 at
//   CH 2, 64 at CH 4 (an 8-byte spill), 114 at CH 8.
// * Why not more gathers in flight: 32 a batch doubles the registers and
//   halves the resident warps, and splitting every row's groups over warps
//   leaves most warps a group of padding; both were slower at R 8192. What
//   still holds the padded launch back is its tail: the 168 hub rows of
//   skewed-powerlaw (128-129 live slots) each run 16 dependent batches.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kBatch = 8;              // live slots whose gathers are in flight together
constexpr int kSplitBelowRows = 4096;  // split a row's slot groups over warps below this R
constexpr unsigned kAll = 0xffffffffu;

template <int CH>  // columns per lane per pass: 32 * CH columns a pass
__global__ void __launch_bounds__(kMaxWarps * 32)
spmm_kernel(const float* __restrict__ hw,         // (N, F)
            const int* __restrict__ neighbors,    // (R, W)
            const float* __restrict__ norm,       // (R, W)
            float* __restrict__ out,              // (R, F)
            long long rows, int width, int feat, long long num_nodes, int split,
            int rows_per_block, int groups_per_part) {
  __shared__ float part[kMaxWarps][32 * CH];
  __shared__ int part_bad[kMaxWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part_id = warp % split;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / split;
  const bool active = row < rows;
  const int ngroups = (width + 31) / 32;
  const int g_begin = part_id * groups_per_part;
  const int g_end = min(ngroups, g_begin + groups_per_part);
  const int* nbr_row = neighbors + (active ? row : 0) * width;
  const float* norm_row = norm + (active ? row : 0) * width;

  for (int f0 = 0; f0 < feat; f0 += 32 * CH) {
    float acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = 0.f;
    bool bad = false;
    if (active && g_begin < g_end) {
      int idx_next = 0;
      float nrm_next = 0.f;
      {
        const int w = g_begin * 32 + lane;
        if (w < width) {
          idx_next = __ldg(nbr_row + w);
          nrm_next = __ldg(norm_row + w);
        }
      }
      for (int gi = g_begin; gi < g_end; ++gi) {
        const int w = gi * 32 + lane;
        const int idx = idx_next;
        const float nrm = nrm_next;
        if (gi + 1 < g_end) {  // the next 32 slots load while these are summed
          const int wn = w + 32;
          idx_next = wn < width ? __ldg(nbr_row + wn) : 0;
          nrm_next = wn < width ? __ldg(norm_row + wn) : 0.f;
        }
        const bool oob = w < width && (idx < 0 || (long long)idx >= num_nodes);
        if (__any_sync(kAll, oob)) {
          bad = true;
          break;
        }
        unsigned live = __ballot_sync(kAll, w < width && nrm != 0.f);
        while (live) {  // kBatch live slots at a time: all their gathers, then the sums
          const int count = min(__popc(live), kBatch);
          int src[kBatch];
          float a[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int from = j < count ? __ffs(live) - 1 : 0;
            src[j] = __shfl_sync(kAll, idx, from);
            a[j] = __shfl_sync(kAll, nrm, from);
            if (j < count) live &= live - 1;
          }
          float x[kBatch][CH];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
#pragma unroll
            for (int c = 0; c < CH; ++c) {
              const int col = f0 + c * 32 + lane;
              x[j][c] = (j < count && col < feat) ? __ldg(hw + (long long)src[j] * feat + col) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j < count) {
#pragma unroll
              for (int c = 0; c < CH; ++c) acc[c] = fmaf(a[j], x[j][c], acc[c]);
            }
          }
        }
      }
    }

    if (split == 1) {
      if (active) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int col = f0 + c * 32 + lane;
          if (col < feat) out[row * feat + col] = bad ? CUDART_NAN_F : acc[c];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c) part[warp][c * 32 + lane] = acc[c];
      if (lane == 0) part_bad[warp] = bad;
      __syncthreads();
      if (active && part_id == 0) {
        bool row_bad = false;
        for (int p = 0; p < split; ++p) row_bad |= part_bad[warp + p] != 0;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int col = f0 + c * 32 + lane;
          float sum = part[warp][c * 32 + lane];
          for (int p = 1; p < split; ++p) sum += part[warp + p][c * 32 + lane];
          if (col < feat) out[row * feat + col] = row_bad ? CUDART_NAN_F : sum;
        }
      }
      __syncthreads();  // the partials are read before the next pass writes them
    }
  }
}

template <int CH>
int launch(const float* hw, const int* neighbors, const float* norm, float* out, long long rows,
           int width, int feat, long long num_nodes, cudaStream_t stream) {
  const int ngroups = (width + 31) / 32;
  const int split = (rows < kSplitBelowRows && ngroups > 1) ? (ngroups < kMaxWarps ? ngroups : kMaxWarps) : 1;
  const int rows_per_block = kMaxWarps / split;
  const int groups_per_part = (ngroups + split - 1) / split;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  spmm_kernel<CH><<<(unsigned)blocks, rows_per_block * split * 32, 0, stream>>>(
      hw, neighbors, norm, out, rows, width, feat, num_nodes, split, rows_per_block,
      groups_per_part);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int spmm_forward(const float* hw, const int* neighbors, const float* norm,
                            float* out, long long rows, int width, int feat,
                            long long num_nodes, void* stream) {
  if (rows <= 0 || width <= 0 || feat <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (feat <= 32) return launch<1>(hw, neighbors, norm, out, rows, width, feat, num_nodes, s);
  if (feat <= 64) return launch<2>(hw, neighbors, norm, out, rows, width, feat, num_nodes, s);
  if (feat <= 128) return launch<4>(hw, neighbors, norm, out, rows, width, feat, num_nodes, s);
  return launch<8>(hw, neighbors, norm, out, rows, width, feat, num_nodes, s);
}
