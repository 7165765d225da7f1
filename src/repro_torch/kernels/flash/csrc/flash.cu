// Causal flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash/kernel.py:74, pallas_call :102, body :29).
//
// For every batch b, query head h and query row i (positions are 0-based
// row indices of q and of k/v):
//   s_ij = softcap( (scale * q_i) . k_j )          scale = 1/sqrt(hd)
//   ok_ij = j <= i  and  (window <= 0  or  i - j < window)
//   out_i = sum_j p_ij v_j / max(sum_j p_ij, 1e-30),  p_ij = ok_ij exp(s_ij - m_i)
// with an online softmax over KV tiles (running max m, sum l, accumulator),
// in fp32 whatever the input type (fp32 or bf16; the output takes q's type).
// GQA: query head h reads kv head h / (H / KV) — the Pallas kernel's kv_row
// fold (:99) in the model's (B, S, heads, dim) layout, which this kernel
// reads and writes directly, so the op moves no axis.
//
// What bounds it on this card: operations. At the serving prefill's shape
// (4 sequences x 32 heads, S 512, hd 128) it does ~2 S^2 hd flops per head
// over ~0.25 MB of q/k/v/out per head: far above the H100's ~20 flop/byte
// fp32 balance point. This first kernel runs them on the CUDA cores (no
// tensor cores, wgmma or TMA): a block of 256 threads (16 x 16) owns 64
// query rows of one (b, h); each thread holds a 4 x 4 tile of the 64 x 64
// score block and a 4-row slice of the output accumulator (columns tx,
// tx+16, ...). Q (pre-scaled), K transposed and V are staged in shared
// memory as fp32 with padded strides (no bank conflicts on the score loop);
// P goes through shared memory for the P.V product. KV tiles wholly above
// the diagonal or wholly outside the window are skipped (they add exactly
// nothing). Any Sq and Skv: ragged tails are masked by bounds.
// Shared memory: 4 * (64 (hd+1) + hd 65 + 64 hd_v + 64 * 65) bytes —
// 115,712 at hd = hd_v = 128, 214,528 at 256 — so the launch opts into
// dynamic shared memory above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DV>  // DV accumulator columns per thread: hd_v <= 16 * DV
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,  // (B, Sq, H, hd)
             const T* __restrict__ k,  // (B, Skv, KV, hd)
             const T* __restrict__ v,  // (B, Skv, KV, hd_v)
             T* __restrict__ out,      // (B, Sq, H, hd_v)
             int Sq, int Skv, int H, int KV, int hd, int hdv, float scale,
             int window, float softcap) {
  extern __shared__ float smem[];
  const int qstride = hd + 1;
  const int kstride = kBKV + 1;
  const int pstride = kBKV + 1;
  float* Qs = smem;                  // kBQ x (hd + 1)
  float* Kt = Qs + kBQ * qstride;    // hd x (kBKV + 1): K transposed
  float* Vs = Kt + hd * kstride;     // kBKV x hd_v
  float* Ps = Vs + kBKV * hdv;       // kBQ x (kBKV + 1)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int qi = q0 + r;
    Qs[r * qstride + d] =
        qi < Sq ? to_f(q[(((long long)b * Sq + qi) * H + h) * hd + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[i][c] = 0.f;
  }

  // causal: no key after the tile's last row; window: none before its reach
  const int kv_end = min(Skv, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = ((q0 - window + 1) / kBKV) * kBKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int e = tid; e < kBKV * hd; e += kThreads) {
      const int c = e / hd, d = e - c * hd;
      const int kj = k0 + c;
      Kt[d * kstride + c] = kj < Skv ? to_f(k[(((long long)b * Skv + kj) * KV + kvh) * hd + d]) : 0.f;
    }
    for (int e = tid; e < kBKV * hdv; e += kThreads) {
      const int c = e / hdv, d = e - c * hdv;
      const int kj = k0 + c;
      Vs[c * hdv + d] = kj < Skv ? to_f(v[(((long long)b * Skv + kj) * KV + kvh) * hdv + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * qstride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kstride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float sv = s[i][j];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        ok[j] = kj < Skv && kj <= qi && (window <= 0 || qi - kj < window);
        s[i][j] = ok[j] ? sv : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * pstride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int jn = min(kBKV, kv_end - k0);  // keys past the end carry p = 0
    for (int j = 0; j < jn; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * pstride + j];
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int col = tx + 16 * c;
        if (col < hdv) {
          const float vv = Vs[j * hdv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + (((long long)b * Sq + qi) * H + h) * hdv;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int col = tx + 16 * c;
      if (col < hdv) store(row + col, acc[i][c] / den);
    }
  }
}

template <typename T, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int KV, int hd, int hdv, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (hd + 1) + (size_t)hd * (kBKV + 1) + (size_t)kBKV * hdv +
                       (size_t)kBQ * (kBKV + 1));
  static size_t opted = 0;  // dynamic shared memory this instantiation may use
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_kernel<T, DV><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KV, hd, hdv, scale, window,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int H, int KV, int hd, int hdv, float scale, int window, float softcap,
             cudaStream_t s) {
  if (hdv <= 16) return launch<T, 1>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
  if (hdv <= 32) return launch<T, 2>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
  if (hdv <= 64) return launch<T, 4>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
  if (hdv <= 128) return launch<T, 8>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
  return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int Sq, int Skv, int H, int KV, int hd, int hdv,
                             float scale, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256 || hdv <= 0 || hdv > 256 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd, hdv, scale, window,
                                   softcap, s);
  return (int)cudaErrorInvalidValue;
}
