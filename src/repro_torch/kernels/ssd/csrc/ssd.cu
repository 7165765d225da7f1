// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_kernel (src/repro/kernels/ssd/kernel.py:65,
// pallas_call :84, body :29). Per (batch b, head h), over chunks of Q tokens
// walked in order, with la the in-chunk cumulative sum of loga = A[h] dt and
// xd = x * dt:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) xd_j  +  exp(la_i) C_i . H^T
//   H'    = exp(la_Q) H + sum_j exp(la_Q - la_j) xd_j (x) B_j          H: (P, N)
// starting from H = 0 (the serving prefill's state, as in the TPU kernel).
// It writes y (b, S, h, P) and the final state H (b, h, P, N), which the
// decode cache needs (the TPU kernel kept it only in VMEM scratch).
// B and C are read by batch index from (b, S, N): the per-head copies the
// JAX op makes (ssd/ops.py:11) are not needed. A ragged last chunk is read
// as zeros past S (dt = loga = 0: decay 1, no update), and y is written
// only below S.
//
// What bounds it on this card: operations. Per chunk and head it does
// ~Q^2 N / 2 (C B^T, causal) + Q^2 P / 2 + Q P N (y) + 2 Q P N (state)
// multiply-adds over ~Q (2N + 2P) floats of input: at Q 128, P 64, N 128
// about 10 MFLOP for 200 KB. This first kernel uses the CUDA cores (no
// tensor cores): one block of 256 threads per (b, h), the (P, N) state in
// shared memory for the whole row, the chunk's B and x*dt in shared memory,
// and the queries in blocks of 32 rows so that C . B^T never needs a Q x Q
// tile: per row block, G = (C_rows B^T) o decay (32 x Q) goes through shared
// memory, then y = G xd + exp(la) C_rows H^T. B, C and H rows use a padded
// stride (N + 1) so neighbouring threads hit different banks. Shared memory:
// 4 (P (N+1) + Q (N+1) + Q P + 32 (N+1) + 32 Q + 2 Q) bytes = 165,760 at
// Q 128, P 64, N 128, above 48 KB, so the launch opts into it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // query rows per block of the y computation

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x,     // (b, S, nh, P)
           const float* __restrict__ dt,    // (b, S, nh)
           const float* __restrict__ loga,  // (b, S, nh)
           const float* __restrict__ Bm,    // (b, S, N)
           const float* __restrict__ Cm,    // (b, S, N)
           float* __restrict__ y,           // (b, S, nh, P)
           float* __restrict__ hout,        // (b, nh, P, N)
           int S, int nh, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int bs = N + 1;
  float* Hs = smem;               // P x (N + 1): the carried state
  float* Bs = Hs + P * bs;        // Q x (N + 1)
  float* Xd = Bs + Q * bs;        // Q x P: x * dt
  float* Cs = Xd + Q * P;         // kRows x (N + 1)
  float* Gs = Cs + kRows * bs;    // kRows x Q
  float* cums = Gs + kRows * Q;   // Q: in-chunk cumulative loga
  float* wts = cums + Q;          // Q: exp(la_Q - la_j)

  const int bi = blockIdx.x / nh, hi = blockIdx.x - (blockIdx.x / nh) * nh;
  const int tid = threadIdx.x;
  const long long tok0 = (long long)bi * S;  // first token row of this batch

  for (int e = tid; e < P * N; e += kThreads) Hs[(e / N) * bs + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's state update is done
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      const int t = c0 + j;
      Bs[j * bs + n] = t < S ? Bm[(tok0 + t) * N + n] : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      const int t = c0 + j;
      Xd[j * P + p] = t < S ? x[((tok0 + t) * nh + hi) * P + p] * dt[(tok0 + t) * nh + hi] : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads) {
      const int t = c0 + j;
      cums[j] = t < S ? loga[(tok0 + t) * nh + hi] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // in-chunk inclusive cumsum, in token order
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += cums[j];
        cums[j] = run;
      }
    }
    __syncthreads();
    const float last = cums[Q - 1];
    for (int j = tid; j < Q; j += kThreads) wts[j] = expf(last - cums[j]);

    // y, one block of query rows at a time, against the state entering the chunk
    for (int r0 = 0; r0 < Q && c0 + r0 < S; r0 += kRows) {
      const int rows = min(kRows, Q - r0);
      for (int e = tid; e < rows * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        const int t = c0 + r0 + i;
        Cs[i * bs + n] = t < S ? Cm[(tok0 + t) * N + n] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < rows * Q; e += kThreads) {
        const int i = e / Q, j = e - i * Q;
        const int ig = r0 + i;
        float g = 0.f;
        if (j <= ig) {
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(Cs[i * bs + n], Bs[j * bs + n], dot);
          g = dot * expf(cums[ig] - cums[j]);
        }
        Gs[i * Q + j] = g;
      }
      __syncthreads();
      for (int e = tid; e < rows * P; e += kThreads) {
        const int i = e / P, p = e - i * P;
        const int ig = r0 + i;
        const int t = c0 + ig;
        float intra = 0.f;
        for (int j = 0; j <= ig; ++j) intra = fmaf(Gs[i * Q + j], Xd[j * P + p], intra);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(Cs[i * bs + n], Hs[p * bs + n], inter);
        if (t < S) y[((tok0 + t) * nh + hi) * P + p] = intra + inter * expf(cums[ig]);
      }
      __syncthreads();  // Cs and Gs are rewritten by the next row block
    }

    // state update: each thread owns its (p, n) entries
    const float el = expf(last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float upd = 0.f;
      for (int j = 0; j < Q; ++j) upd = fmaf(Xd[j * P + p] * wts[j], Bs[j * bs + n], upd);
      Hs[p * bs + n] = el * Hs[p * bs + n] + upd;
    }
  }
  __syncthreads();
  float* hrow = hout + ((long long)bi * nh + hi) * P * N;
  for (int e = tid; e < P * N; e += kThreads) hrow[e] = Hs[(e / N) * bs + e % N];
}

}  // namespace

// Dynamic shared memory the kernel needs at (P, N, Q), in bytes.
extern "C" long long ssd_smem_bytes(int P, int N, int Q) {
  const long long bs = N + 1;
  return 4LL * (P * bs + Q * bs + (long long)Q * P + kRows * bs + (long long)kRows * Q + 2LL * Q);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int ssd_forward(const float* x, const float* dt, const float* loga, const float* B,
                           const float* C, float* y, float* h, int batch, int S, int nh, int P,
                           int N, int Q, void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0 || P <= 0 || N <= 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = ssd_smem_bytes(P, N, Q);
  static long long opted = 0;
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  ssd_kernel<<<(unsigned)(batch * nh), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      x, dt, loga, B, C, y, h, S, nh, P, N, Q);
  return (int)cudaGetLastError();
}
