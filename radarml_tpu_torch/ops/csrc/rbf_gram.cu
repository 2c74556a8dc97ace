// Fused RBF Gram matrix for the kernel-SVM family (Hopper, sm_90a).
//
// Replaces the TPU kernel radarml_tpu/ops/pallas_rbf.py :: rbf_gram (body
// _kernel). For row-major float32 X (n, F) and S (m, F) it writes
//
//   K[r, c] = expf(-gamma * max(|x_r|^2 + |s_c|^2 - 2 <x_r, s_c>, 0))
//
// as a row-major (n, m) float32 matrix, every element exactly once. The
// SVC fit calls it on its training set (n = m = samples) and serving on
// the query features against the support vectors (n = scans * targets,
// m = n_sv).
//
// What bounds it on an H100: FP32 FMA throughput. At the serving shape
// (16,384 queries x 1,823 support vectors x 10,010 features) it does
// 2*n*m*F ~ 6.0e11 flops against (n+m)*F*4 ~ 0.73 GB of reads, ~800 flops
// a byte, far above the card's ~20 flops a byte of FP32 SIMT against device
// memory. The peak is 67 TFLOP/s of FP32 FMAs outside the tensor cores, so
// the serving shape needs at least ~9 ms. This kernel uses no TF32 and no
// tensor cores: a float32 Gram has to keep float32's digits, because
// |x|^2 + |s|^2 - 2<x,s> cancels for near points. A 3xTF32 wgmma product is
// the later, faster design.
//
// What the design does about it (the classic SIMT SGEMM shape):
// - One block of 256 threads computes a 128 x 128 output tile; each thread
//   keeps an 8 x 8 register tile (four 4 x 4 quadrants, so its shared loads
//   are float4 and conflict-free) and accumulates 64 FMAs per 16 floats it
//   reads from shared memory.
// - F is walked in chunks of 8 columns, staged in shared memory transposed
//   ([k][row], rows padded to 132 so the transposing stores do not
//   conflict) and double-buffered: the next chunk's global loads are in
//   flight in registers while the block computes on the current one.
// - Precision. For near points |x|^2 + |s|^2 - 2<x,s> cancels (|x|^2 is
//   ~360 for the scaled radar features), so the rounding error of each sum
//   over F lands in the distance whole. One running float sum over
//   F = 10,010 products errs by ~sqrt(F) ulps of the sum, ten times more
//   than cuBLAS's sliced products (measured on an H100). So <x,s> is summed
//   in two levels: each thread's 8 x 8 register tile collects 32 chunks
//   (256 columns of F) in a fresh partial tile that is then added to the
//   running one, which cuts that error by ~10x. The running tiles live in
//   shared memory (64 KB a block, touched once per 256 columns), not in
//   registers, so a thread keeps ~128 registers and two blocks share an SM
//   (with both tiles in registers, 203 registers and one block per SM took
//   26.66 ms against 21.72 at the serving shape, H100 80GB HBM3, 700 W).
//   |x|^2 and |s|^2 are accumulated in the same pass over F, from the same
//   shared chunks, in double (one accumulator a thread, 8 FP64 FMAs per
//   512 FP32 ones), and the epilogue forms xx + ss - 2g in double before
//   rounding d2 to float. Against a float64 oracle the kernel's error is
//   then at most the plain version's (cuBLAS SGEMM, tree-summed norms).
// - Rows of F = 10,010 floats are 40,040 bytes apart, so only every other
//   row starts on a 16-byte boundary: global loads are scalar, four
//   consecutive floats of one row per thread (a warp reads 16 rows x 32
//   bytes, whole sectors).
// - Ragged edges (n, m, F not multiples of the tile) are masked in the
//   kernel: loads outside the matrices read 0, and stores outside (n, m)
//   are skipped. No padding is allocated and nothing is sliced afterwards.
// - The epilogue applies max(xx + ss - 2g, 0) and expf (not __expf) while
//   the tile is still on chip, before the single store.
// Where it stands: 27.5 TFLOP/s at the serving shape (21.72 ms against 13.68
// for the plain version, H100 80GB HBM3, 700 W), 41% of the FP32 peak. What
// holds it there is not measured (no ncu on the card's machine); the likely
// cause is dispatch slots shared by the shared-memory loads, the FMAs and the
// chunk's loads and syncs with only 16 warps an SM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 128;     // output rows and columns per block
constexpr int kChunk = 8;      // F columns per shared-memory stage
constexpr int kPitch = 132;    // padded row pitch of a staged chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kFlush = 32;     // chunks summed in a partial tile before it is added
constexpr int kAccBytes = 64 * kThreads * (int)sizeof(float);  // running sums

struct Stage {
  float x[kChunk][kPitch];  // X chunk, transposed: [k][row]
  float s[kChunk][kPitch];  // S chunk, transposed: [k][row]
};

// Thread t loads 4 consecutive F columns of one row of each operand:
// row t / 2, columns (t % 2) * 4 + 0..3 of the chunk.
__device__ __forceinline__ void load_chunk(const float* __restrict__ A, int rows, int row0,
                                           int F, int k0, float (&r)[4]) {
  const int row = row0 + threadIdx.x / 2;
  const int k = k0 + (threadIdx.x % 2) * 4;
  const float* p = A + (size_t)row * F + k;
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = (row < rows && k + i < F) ? p[i] : 0.f;
}

__device__ __forceinline__ void store_chunk(float (*dst)[kPitch], const float (&r)[4]) {
  const int row = threadIdx.x / 2;
  const int k = (threadIdx.x % 2) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[k + i][row] = r[i];
}

__global__ void __launch_bounds__(kThreads, 2)
    rbf_gram_kernel(const float* __restrict__ X, const float* __restrict__ S,
                    float* __restrict__ out, int n, int m, int F, float gamma) {
  __shared__ __align__(16) Stage stage[2];
  __shared__ double xx_s[kTile];
  __shared__ double ss_s[kTile];
  // The running sums: element e of thread t at acc_s[e * kThreads + t], so
  // a warp's accesses are consecutive words (kAccBytes of dynamic memory).
  extern __shared__ float acc_s[];

  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // Threads 0..127 keep |x|^2 of tile row t, threads 128..255 |s|^2 of
  // tile column t - 128.
  const bool norm_of_x = threadIdx.x < kTile;
  const int norm_row = threadIdx.x % kTile;

  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      part[i][j] = 0.f;
      acc_s[(i * 8 + j) * kThreads + threadIdx.x] = 0.f;
    }
  double norm = 0.0;

  float rx[4], rs[4];
  load_chunk(X, n, row0, F, 0, rx);
  load_chunk(S, m, col0, F, 0, rs);
  store_chunk(stage[0].x, rx);
  store_chunk(stage[0].s, rs);
  __syncthreads();

  const int n_chunks = (F + kChunk - 1) / kChunk;
  for (int kt = 0; kt < n_chunks; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < n_chunks;
    if (more) {  // next chunk's loads fly while this one is computed
      load_chunk(X, n, row0, F, (kt + 1) * kChunk, rx);
      load_chunk(S, m, col0, F, (kt + 1) * kChunk, rs);
    }
    const Stage& st = stage[buf];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&st.x[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&st.x[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&st.s[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&st.s[k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      const double v = norm_of_x ? st.x[k][norm_row] : st.s[k][norm_row];
      norm = fma(v, v, norm);
    }
    if (kt % kFlush == kFlush - 1 || !more) {  // second level of the sum
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_s[(i * 8 + j) * kThreads + threadIdx.x] += part[i][j];
          part[i][j] = 0.f;
        }
    }
    if (more) {  // the other buffer was last read before the previous sync
      store_chunk(stage[buf ^ 1].x, rx);
      store_chunk(stage[buf ^ 1].s, rs);
    }
    __syncthreads();
  }

  (norm_of_x ? xx_s : ss_s)[norm_row] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    const int gr = row0 + r;
    if (gr >= n) continue;
    const double xx = xx_s[r];
    float* orow = out + (size_t)gr * m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      const int gc = col0 + c;
      if (gc >= m) continue;
      const double g = acc_s[(i * 8 + j) * kThreads + threadIdx.x];
      const float d2 = (float)fmax(xx + ss_s[c] - 2.0 * g, 0.0);
      orow[gc] = expf(-gamma * d2);
    }
  }
}

}  // namespace

extern "C" {

// Launch the fused Gram matrix on `stream`: out (n, m) row-major float32
// from row-major float32 X (n, F) and S (m, F). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes it does not take);
// the launch does not synchronise.
int rbf_gram_f32(const void* X, const void* S, void* out, int n, int m, int F, float gamma,
                 void* stream) {
  if (n < 1 || m < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid_y = (unsigned)((n + kTile - 1) / kTile);
  if (grid_y > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kTile - 1) / kTile), grid_y);
  cudaError_t err = cudaFuncSetAttribute(
      rbf_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAccBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rbf_gram_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  rbf_gram_kernel<<<grid, kThreads, kAccBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(S), static_cast<float*>(out), n,
      m, F, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
