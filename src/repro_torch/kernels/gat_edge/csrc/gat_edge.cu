// Fused GAT neighbour attention for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of src/repro/kernels/gat_edge/kernel.py:
//   * gat_aggregate_kernel (_gat_call, pallas_call at :70) — padded layout,
//     rows are the graph's nodes (row_node == nullptr);
//   * bucket_gat_kernel (_bucket_gat_call, pallas_call at :164) — one degree
//     bucket, tile row r holds node row_node[r].
//
// Per (row, head), with node = row_node ? row_node[row] : row:
//   e_j   = LeakyReLU(s_src[node, head] + s_dst[nbr_j, head]), -1e9 where masked
//   m     = max_j e_j
//   p_j   = exp(e_j - m) * mask_j,   l = max(sum_j p_j, 1e-30)
//   out[row, head, :] = sum_j (p_j / l) * hw[nbr_j, head, :]      (f32)
//
// Unlike the TPU versions, the kernel gathers the scores and the feature rows
// itself: neither the (H, N, D, F) gathered features of the padded path nor
// the (H, R, W) gathered scores ever exist in device memory.
//
// What bounds it on this card: bytes. Each live slot costs one 4-byte score
// gather and an F*4-byte feature-row gather against ~2F flops, far below the
// H100's ~20 flop/byte balance point for fp32. Design: one warp owns one
// (row, head) output row, so there are no atomics and no shared memory (any
// width W works, none is sized by a maximum). Lanes stride over the W slots
// for the max and the sum (shuffle reductions), then the weighted sum splits
// the warp into 32/F lane groups (F <= 32; wider F loops over 32-column
// chunks) that each take every (32/F)-th slot of a 32-slot tile, with the
// slot's weight and index broadcast by shuffle. Adjacent warps take the
// heads of the same row, so one block's feature loads of a neighbour row
// (H*F contiguous floats) coalesce. Scores are recomputed in each of the
// three passes instead of being staged: they are W*4 bytes of L1/L2 hits.
//
// The mask is not assumed to be a prefix (subgraph() leaves holes); padding
// slots hold index 0 and only the mask excludes them. A fully masked row
// gives exactly 0. A live slot (or a row_node) whose index lies outside
// [0, num_nodes) is never dereferenced: that output row is set to NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float leaky_relu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_edge_kernel(const float* __restrict__ hw,          // (N, H, F)
                const float* __restrict__ s_src,       // (N, H)
                const float* __restrict__ s_dst,       // (N, H)
                const int* __restrict__ neighbors,     // (R, W)
                const unsigned char* __restrict__ mask,  // (R, W) bool
                const int* __restrict__ row_node,      // (R,) or nullptr
                float* __restrict__ out,               // (R, H, F)
                long long rows, int width, int heads, int feat,
                long long num_nodes, float negative_slope) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (task >= rows * heads) return;  // warp-uniform: the whole warp leaves
  const long long row = task / heads;
  const int head = (int)(task % heads);
  const long long node = row_node != nullptr ? (long long)row_node[row] : row;
  const int* nbr_row = neighbors + row * width;
  const unsigned char* mask_row = mask + row * width;
  float* out_row = out + (row * heads + head) * feat;

  bool bad = node < 0 || node >= num_nodes;
  const float s_self = bad ? 0.f : s_src[node * heads + head];

  // pass 1: max over all W slots, masked slots counting as -1e9
  float m = -CUDART_INF_F;
  for (int j = lane; j < width; j += 32) {
    float e = kMaskedScore;
    if (mask_row[j]) {
      const int nb = nbr_row[j];
      if (nb < 0 || nb >= num_nodes) {
        bad = true;
      } else {
        e = leaky_relu(s_self + s_dst[(long long)nb * heads + head], negative_slope);
      }
    }
    m = fmaxf(m, e);
  }
  if (__any_sync(kFullMask, bad)) {
    for (int f = lane; f < feat; f += 32) out_row[f] = CUDART_NAN_F;
    return;
  }
  m = warp_max(m);

  // pass 2: softmax denominator over the live slots
  float l = 0.f;
  for (int j = lane; j < width; j += 32) {
    if (mask_row[j]) {
      const int nb = nbr_row[j];
      l += expf(leaky_relu(s_self + s_dst[(long long)nb * heads + head], negative_slope) - m);
    }
  }
  l = fmaxf(warp_sum(l), 1e-30f);

  // pass 3: out = sum_j alpha_j * hw[nbr_j, head, :], 32 columns at a time
  for (int f0 = 0; f0 < feat; f0 += 32) {
    const int fc = min(feat - f0, 32);
    const int groups = 32 / fc;
    const int group = lane / fc;  // >= groups on the idle lanes
    const int f = f0 + lane % fc;
    float acc = 0.f;
    for (int base = 0; base < width; base += 32) {
      const int j = base + lane;
      float alpha = 0.f;
      int nb = -1;  // -1: not a live slot
      if (j < width && mask_row[j]) {
        nb = nbr_row[j];
        alpha = expf(leaky_relu(s_self + s_dst[(long long)nb * heads + head],
                                negative_slope) - m) / l;
      }
      const int count = min(32, width - base);
      for (int k0 = 0; k0 < count; k0 += groups) {  // warp-uniform trip count
        const int k = k0 + group;
        const float a = __shfl_sync(kFullMask, alpha, k & 31);
        const int n = __shfl_sync(kFullMask, nb, k & 31);
        if (group < groups && k < count && n >= 0) {
          acc += a * hw[((long long)n * heads + head) * feat + f];
        }
      }
    }
    // fold the groups' partial sums onto lanes 0..fc-1, group order fixed
    float total = acc;
    for (int g = 1; g < groups; ++g) {
      total += __shfl_sync(kFullMask, acc, (lane + g * fc) & 31);
    }
    if (lane < fc) out_row[f] = total;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int gat_edge_forward(const float* hw, const float* s_src, const float* s_dst,
                                const int* neighbors, const unsigned char* mask,
                                const int* row_node, float* out, long long rows,
                                int width, int heads, int feat, long long num_nodes,
                                float negative_slope, void* stream) {
  if (rows <= 0 || heads <= 0 || feat <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows * heads + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  gat_edge_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      hw, s_src, s_dst, neighbors, mask, row_node, out, rows, width, heads, feat,
      num_nodes, negative_slope);
  return (int)cudaGetLastError();
}
