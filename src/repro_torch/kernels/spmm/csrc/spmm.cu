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
// in slot order w = 0..W-1. There is no mask: padding slots carry norm 0 and
// index 0 and are summed like any other slot, as padded_spmm_ref does, so a
// row whose norms are all 0 comes out exactly 0. A slot whose index lies
// outside [0, N) is never dereferenced: that output row is set to NaN.
//
// What bounds it on this card: bytes. Each slot costs a 4-byte index, a
// 4-byte norm and an F*4-byte feature-row gather for 2F flops, far below
// the H100's ~20 flop/byte balance point for fp32. Design: a group of L
// lanes owns one output row (L = F rounded up to a power of two, at most
// 32), so a warp holds 32/L rows when F < 32 and one row when F >= 32 (then
// each lane walks the columns f, f+32, ...). Every lane of a group reads
// the same index and norm (one broadcast load) and a neighbouring column of
// the gathered row, so the row gather is one coalesced access. No atomics
// and no shared memory: each output row belongs to one group, and no width
// W is sized by a maximum.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

template <int L>  // lanes per output row: a power of two, 1..32
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ hw,         // (N, F)
            const int* __restrict__ neighbors,    // (R, W)
            const float* __restrict__ norm,       // (R, W)
            float* __restrict__ out,              // (R, F)
            long long rows, int width, int feat, long long num_nodes) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / L;
  if (row >= rows) return;  // no shuffles below, so lanes may leave early
  const int lane = (int)(t % L);
  const int* nbr_row = neighbors + row * width;
  const float* norm_row = norm + row * width;
  float* out_row = out + row * feat;

  // every lane of the group reads the same indices, so `bad` agrees across
  // the group; the first column pass sees every slot
  bool bad = false;
  for (int f0 = 0; f0 < feat && !bad; f0 += L) {
    const int f = f0 + lane;
    const bool has_col = f < feat;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < width; ++j) {
      const int n = __ldg(nbr_row + j);
      const float a = __ldg(norm_row + j);
      const bool in_range = n >= 0 && (long long)n < num_nodes;
      bad |= !in_range;
      if (in_range && has_col) acc = fmaf(a, __ldg(hw + (long long)n * feat + f), acc);
    }
    if (has_col && !bad) out_row[f] = acc;
  }
  if (bad) {
    for (int f = lane; f < feat; f += L) out_row[f] = CUDART_NAN_F;
  }
}

template <int L>
void launch(const float* hw, const int* neighbors, const float* norm, float* out,
            long long rows, int width, int feat, long long num_nodes, unsigned blocks,
            cudaStream_t stream) {
  spmm_kernel<L><<<blocks, kThreads, 0, stream>>>(hw, neighbors, norm, out, rows, width,
                                                  feat, num_nodes);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int spmm_forward(const float* hw, const int* neighbors, const float* norm,
                            float* out, long long rows, int width, int feat,
                            long long num_nodes, void* stream) {
  if (rows <= 0 || width <= 0 || feat <= 0) return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < feat && lanes < 32) lanes <<= 1;
  const long long blocks = (rows * lanes + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = (unsigned)blocks;
  switch (lanes) {
    case 1: launch<1>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
    case 2: launch<2>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
    case 4: launch<4>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
    case 8: launch<8>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
    case 16: launch<16>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
    default: launch<32>(hw, neighbors, norm, out, rows, width, feat, num_nodes, b, s); break;
  }
  return (int)cudaGetLastError();
}
