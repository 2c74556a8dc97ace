// The y-split and sel one-pass int8 table kernels of the fused predict path
// (Hopper, sm_90a). The combo, lookup and sel3 kernels are in i8_score.cu.
//
// Replaces, in radarml_tpu/ops/pallas_i8_score.py:
//   tables_ysplit_kernel  <- onepass_tables_grouped_i8 (_kernel_grouped_tables), "glookup"
//   tables_sel_kernel     <- onepass_tables_sel_i8 (_kernel_sel), "sel"
//
// For each scan b of an int8 cube batch v (B, X, Y, Z) holding value-128,
// and int8 class templates qxz (C2, X, Z), qyz (C2, Y, Z), qxy (C2, X, Y),
// the tables are
//
//   m1[c, y] = sum_{x,z} qxz[c, x, z] * v[b, x, y, z]
//   m2[c, x] = sum_{y,z} qyz[c, y, z] * v[b, x, y, z]
//   m3[z, c] = sum_{x,y} qxy[c, x, y] * v[b, x, y, z]
//
// exactly, in int32, as in i8_score.cu. A null template pointer is a
// masked plane: its table is zero and its work is skipped.
//
// What bounds them on an H100: the cube read, 22*31*176 = 120,032 bytes a
// scan at the default arena, so 0.147 ms for 4096 scans at 3.35 TB/s. At a
// serving batch of 1-64 scans that read is under 3 us: launch latency and
// the number of blocks in flight bound it.
//
// What the design does about it. Both share one block routine,
// tile_tables: a block takes a tile of one scan (every x and z, a
// y-range), walks it in x-chunks sized to fit about 100 KB of shared
// memory, and sums the tile's part of all three tables in shared memory
// (row dots with __dp4a for m1/m2, byte-transposed row quads with __dp4a
// for m3). The kernels differ in how a scan is cut into tiles and in what
// they write:
// - y-split: a scan is ceil(Y / Yg) blocks (any Yg from 1 to Y), each
//   reading X runs of Yg*Z contiguous bytes. A block owns its y-group's m1
//   rows and adds its m2 and m3 partials into zeroed outputs with int32
//   atomicAdd. Integer atomics are exact in any order, so the tables stay
//   bit-equal to the plain version.
// - sel: one block per scan; m1 and m2 are written, m3 stays in shared
//   memory (Z*C2*4 = 4.2 KB) and only d3[b, t, c] = m3[kidx[b, t], c]
//   leaves it (0 where kidx is outside [0, Z), -1 included).
// Outputs are scan-major (B, C2, Y), (B, C2, X), (B, Z, C2) and
// (B, T, C2); the wrapper views them in the JAX axis order.
// Simple first: loads are synchronous (no cp.async ring) and every block
// re-reads its templates from L2. What that costs, on an H100 80GB HBM3
// (700 W), device time, levels 2: at B=4096 y-split (Yg 16) 0.92, sel
// 1.14, against the dp4a combo kernel's 0.79; at B=64 0.034-0.041 and
// 0.061-0.074 against 0.032-0.038, while the y-split at Yg 8 takes 0.022.
// i8_score.cu's int8 mma walk, which the lookup and sel3 kernels share
// with the combo kernel, is what these two would move to.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC2 = 8;                 // class rows (levels * classes) per table
constexpr int kThreads = 256;
constexpr size_t kSmemTarget = 100 * 1024;  // x-chunk sizing: two blocks per SM
constexpr size_t kSmemMax = 232448;         // one block's dynamic maximum (227 KB)

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int n, int m) { return (n + m - 1) / m; }

// What every kernel is given: the cube, the templates and the tiling.
struct Args {
  const int8_t* cube;
  const int8_t* qxz;
  const int8_t* qyz;
  const int8_t* qxy;
  int X, Y, Z, C2;
  int YN;        // the largest tile's y-extent
  int XS;        // x-chunk width
  int vec_cube;  // Z % 16 == 0 and the cube 16-byte aligned
  int vec_q;     // Z % 16 == 0 and qxz, qyz 16-byte aligned
};

// Shared-memory carve-up of one block, in 32-bit words (each region a
// multiple of 4 words, so 16-byte aligned). Host and device compute it
// the same way from (XS, X, YN, Z, C2).
struct Layout {
  int XS, nchunk, NR, SW;
  int qxz, qyz, qxy, cube, P, Q, m1, m2, m3, words;
  size_t total;  // bytes
};

__host__ __device__ inline Layout make_layout(int XS, int X, int YN, int Z, int C2) {
  Layout L;
  L.XS = XS;
  L.nchunk = cdiv(X, XS);
  L.NR = round_up(XS * YN, 4);  // rows per chunk, whole quads
  L.SW = cdiv(Z, 16) * 4;       // row stride in words: whole 16-byte chunks
  int off = 0;
  L.qxz = off;  off += C2 * XS * L.SW;
  L.qyz = off;  off += C2 * YN * L.SW;
  L.qxy = off;  off += round_up(C2 * L.NR / 4, 4);
  L.cube = off; off += L.NR * L.SW;
  L.P = off;    off += round_up(C2 * L.NR, 4);
  L.Q = off;    off += round_up(C2 * L.NR, 4);
  L.m1 = off;   off += round_up(C2 * YN, 4);
  L.m2 = off;   off += round_up(C2 * X, 4);
  L.m3 = off;   off += cdiv(Z, 4) * 4 * C2;
  L.words = off;
  L.total = (size_t)off * 4;
  return L;
}

// The widest x-chunk, balanced over the chunks, whose block fits
// kSmemTarget (or, at one x, the maximum); 0 if none fits.
int chunk_width(int X, int YN, int Z, int C2) {
  int XS = X;
  while (XS > 1 && make_layout(XS, X, YN, Z, C2).total > kSmemTarget) --XS;
  if (make_layout(XS, X, YN, Z, C2).total > kSmemMax) return 0;
  const int n = cdiv(X, XS);
  return cdiv(X, n);
}

// Copy nrows rows of zn int8 values (row r starts at row(r)) into shared
// rows of SW words, zero-padding each row to SW * 4 bytes: 16-byte loads
// where `vec` (zn % 16 == 0 and every row 16-byte aligned), bytes
// otherwise.
template <class RowPtr>
__device__ void copy_rows(int* dst, int nrows, int zn, int SW, bool vec, RowPtr row) {
  if (vec) {
    const int per = zn / 16;
    for (int i = threadIdx.x; i < nrows * per; i += blockDim.x) {
      const int r = i / per, k = i % per;
      *reinterpret_cast<int4*>(dst + r * SW + 4 * k) =
          __ldg(reinterpret_cast<const int4*>(row(r)) + k);
    }
  } else {
    int8_t* d = reinterpret_cast<int8_t*>(dst);
    const int Zp = SW * 4;
    for (int i = threadIdx.x; i < nrows * Zp; i += blockDim.x) {
      const int r = i / Zp, z = i % Zp;
      d[i] = z < zn ? row(r)[z] : int8_t(0);
    }
  }
}

__device__ inline int dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// The block's share of the three tables for the tile (every x and z, y in
// [y0, y0 + yn)) of scan b, summed into shared memory: m1[c * yn + yl],
// m2[c * X + x], m3[z * C2 + c]. Every thread of the block calls it; on
// return the sums are complete and visible.
__device__ void tile_tables(const Args& a, int b, int y0, int yn, int* smem, const Layout& L) {
  const int tid = threadIdx.x;
  const bool h1 = a.qxz != nullptr, h2 = a.qyz != nullptr, h3 = a.qxy != nullptr;
  const int X = a.X, Y = a.Y, Z = a.Z, C2 = a.C2, SW = L.SW;
  int* qxz_s = smem + L.qxz;   // [c][xl] rows of this chunk
  int* qyz_s = smem + L.qyz;   // [c][yl] rows of the tile
  int* qxy_s = smem + L.qxy;   // [c][NR / 4] words: 4 rows' bytes each
  int* buf = smem + L.cube;    // [r = xl * yn + yl] cube rows of this chunk
  int* P = smem + L.P;         // [c][NR]: row dots against qxz
  int* Q = smem + L.Q;         // [c][NR]: row dots against qyz
  int* m1_s = smem + L.m1;
  int* m2_s = smem + L.m2;
  int* m3_s = smem + L.m3;
  const bool cvec = a.vec_cube, qvec = a.vec_q;
  const int ZV = cdiv(Z, 16), ZW = cdiv(Z, 4), NQ = L.NR / 4;

  if (h2)
    copy_rows(qyz_s, C2 * yn, Z, SW, qvec, [&](int r) {
      return a.qyz + ((size_t)(r / yn) * Y + y0 + r % yn) * Z;
    });
  for (int i = L.m1 + tid; i < L.words; i += blockDim.x) smem[i] = 0;

  for (int ch = 0; ch < L.nchunk; ++ch) {
    const int x0 = ch * L.XS, xs = min(L.XS, X - x0), nr = xs * yn;
    copy_rows(buf, nr, Z, SW, cvec, [&](int r) {
      return a.cube + (((size_t)b * X + x0 + r / yn) * Y + y0 + r % yn) * Z;
    });
    if (h1)
      copy_rows(qxz_s, C2 * xs, Z, SW, qvec, [&](int r) {
        return a.qxz + ((size_t)(r / xs) * X + x0 + r % xs) * Z;
      });
    if (h3) {
      int8_t* d = reinterpret_cast<int8_t*>(qxy_s);
      for (int i = tid; i < C2 * L.NR; i += blockDim.x) {
        const int c = i / L.NR, r = i % L.NR;
        d[i] = r < nr ? a.qxy[((size_t)c * X + x0 + r / yn) * Y + y0 + r % yn] : int8_t(0);
      }
    }
    __syncthreads();  // (A) the chunk and its templates have landed

    // m1/m2 row dots. Item it -> (yl, xl): a warp spans few y and many x,
    // so the qyz rows it reads are near-broadcast.
    if (h1 || h2) {
      for (int it = tid; it < nr; it += blockDim.x) {
        const int yl = it / xs, xl = it % xs, r = xl * yn + yl;
        const int4* v = reinterpret_cast<const int4*>(buf + r * SW);
        const int4* qa = reinterpret_cast<const int4*>(qxz_s + xl * SW);
        const int4* qb = reinterpret_cast<const int4*>(qyz_s + yl * SW);
        int d1[kMaxC2], d2[kMaxC2];
#pragma unroll
        for (int c = 0; c < kMaxC2; ++c) d1[c] = d2[c] = 0;
        for (int k = 0; k < ZV; ++k) {
          const int4 w = v[k];
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c) {
            if (c < C2) {
              if (h1) d1[c] = dot16(w, qa[c * xs * (SW / 4) + k], d1[c]);
              if (h2) d2[c] = dot16(w, qb[c * yn * (SW / 4) + k], d2[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxC2; ++c) {
          if (c < C2) {
            if (h1) P[c * L.NR + r] = d1[c];
            if (h2) Q[c * L.NR + r] = d2[c];
          }
        }
      }
    }

    // m3: item -> (4-z word zw, quad group g), taken from the top thread
    // down so that threads with no row dot start here at once.
    if (h3) {
      const int G = max(1, (int)blockDim.x / ZW);
      for (int it = blockDim.x - 1 - tid; it < ZW * G; it += blockDim.x) {
        const int zw = it % ZW, g = it / ZW;
        int acc[4][kMaxC2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c) acc[i][c] = 0;
        for (int qd = g; qd * 4 < nr; qd += G) {
          const int* row = buf + qd * 4 * SW + zw;
          const int w0 = row[0], w1 = row[SW], w2 = row[2 * SW], w3 = row[3 * SW];
          // 4x4 byte transpose: t_i holds z = 4*zw + i of the four rows.
          const int lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
          const int hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
          const int t[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                            (int)__byte_perm(lo01, lo23, 0x7632),
                            (int)__byte_perm(hi01, hi23, 0x5410),
                            (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c) {
            if (c < C2) {
              const int qc = qxy_s[c * NQ + qd];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][c] = __dp4a(t[i], qc, acc[i][c]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c)
            if (c < C2) atomicAdd(&m3_s[(zw * 4 + i) * C2 + c], acc[i][c]);
      }
    }
    __syncthreads();  // (B) row dots and m3 partials complete

    // m1 += sum over this chunk's x; m2 for this chunk's x columns.
    if (h1)
      for (int i = tid; i < C2 * yn; i += blockDim.x) {
        const int c = i / yn, yl = i % yn;
        int acc = 0;
        for (int xl = 0; xl < xs; ++xl) acc += P[c * L.NR + xl * yn + yl];
        m1_s[i] += acc;
      }
    if (h2)
      for (int i = tid; i < C2 * xs; i += blockDim.x) {
        const int c = i / xs, xl = i % xs;
        int acc = 0;
        for (int yl = 0; yl < yn; ++yl) acc += Q[c * L.NR + xl * yn + yl];
        m2_s[c * X + x0 + xl] = acc;
      }
    __syncthreads();  // (C) sums complete; the chunk buffers are free
  }
}

__global__ void __launch_bounds__(kThreads)
tables_ysplit_kernel(Args a, int yg, int* __restrict__ t1, int* __restrict__ t2,
                     int* __restrict__ t3) {
  extern __shared__ __align__(16) int smem[];
  const Layout L = make_layout(a.XS, a.X, a.YN, a.Z, a.C2);
  const int ng = cdiv(a.Y, yg);
  const int b = blockIdx.x / ng, y0 = (blockIdx.x % ng) * yg, yn = min(yg, a.Y - y0);
  tile_tables(a, b, y0, yn, smem, L);
  const int C2 = a.C2, X = a.X, Y = a.Y, Z = a.Z;
  const int *m1 = smem + L.m1, *m2 = smem + L.m2, *m3 = smem + L.m3;
  for (int i = threadIdx.x; i < C2 * yn; i += blockDim.x)
    t1[((size_t)b * C2 + i / yn) * Y + y0 + i % yn] = m1[i];
  for (int i = threadIdx.x; i < C2 * X; i += blockDim.x)
    if (m2[i]) atomicAdd(&t2[(size_t)b * C2 * X + i], m2[i]);
  for (int i = threadIdx.x; i < Z * C2; i += blockDim.x)
    if (m3[i]) atomicAdd(&t3[(size_t)b * Z * C2 + i], m3[i]);
}

__global__ void __launch_bounds__(kThreads)
tables_sel_kernel(Args a, const int* __restrict__ kidx, int T, int* __restrict__ t1,
                  int* __restrict__ t2, int* __restrict__ d3) {
  extern __shared__ __align__(16) int smem[];
  const Layout L = make_layout(a.XS, a.X, a.YN, a.Z, a.C2);
  const int b = blockIdx.x;
  tile_tables(a, b, 0, a.Y, smem, L);
  const int C2 = a.C2, X = a.X, Y = a.Y, Z = a.Z;
  const int *m1 = smem + L.m1, *m2 = smem + L.m2, *m3 = smem + L.m3;
  for (int i = threadIdx.x; i < C2 * Y; i += blockDim.x) t1[(size_t)b * C2 * Y + i] = m1[i];
  for (int i = threadIdx.x; i < C2 * X; i += blockDim.x) t2[(size_t)b * C2 * X + i] = m2[i];
  for (int i = threadIdx.x; i < T * C2; i += blockDim.x) {
    const int t = i / C2, c = i % C2;
    const int k = kidx[(size_t)b * T + t];
    d3[(size_t)b * T * C2 + i] = (k >= 0 && k < Z) ? m3[k * C2 + c] : 0;
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Fill `a` for a launch whose largest tile spans YN y; false for shapes the
// kernels do not take.
bool make_args(Args& a, const void* cube, const void* qxz, const void* qyz, const void* qxy,
               int B, int X, int Y, int Z, int C2, int YN) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C2 < 1 || C2 > kMaxC2) return false;
  if (!qxz && !qyz && !qxy) return false;
  a.cube = static_cast<const int8_t*>(cube);
  a.qxz = static_cast<const int8_t*>(qxz);
  a.qyz = static_cast<const int8_t*>(qyz);
  a.qxy = static_cast<const int8_t*>(qxy);
  a.X = X; a.Y = Y; a.Z = Z; a.C2 = C2; a.YN = YN;
  a.XS = chunk_width(X, YN, Z, C2);
  a.vec_cube = Z % 16 == 0 && aligned16(cube);
  a.vec_q = Z % 16 == 0 && (!qxz || aligned16(qxz)) && (!qyz || aligned16(qyz));
  return a.XS > 0;
}

// Set the block's shared memory, launch `kernel` on `stream`, and return
// cudaGetLastError(); the launch does not synchronise.
template <typename Kernel, typename... Ts>
int launch(Kernel kernel, long long grid, const Args& a, void* stream, Ts... args) {
  if (grid < 1 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(a.XS, a.X, a.YN, a.Z, a.C2).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tables split along y in groups of yg (1..Y). t2 and t3 must be zeroed
// by the caller; t1 is written in full.
int i8_tails_tables_ysplit(const void* cube, const void* qxz, const void* qyz,
                           const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                           int Y, int Z, int C2, int yg, void* stream) {
  Args a;
  if (yg < 1 || yg > Y || !make_args(a, cube, qxz, qyz, qxy, B, X, Y, Z, C2, yg))
    return (int)cudaErrorInvalidValue;
  return launch(tables_ysplit_kernel, (long long)B * cdiv(Y, yg), a, stream, yg,
                static_cast<int*>(t1), static_cast<int*>(t2), static_cast<int*>(t3));
}

// m1, m2 in full and the selected z-table reads d3 (B, T, C2) of the
// int32 kidx (B, T); every output element is written.
int i8_tails_tables_sel(const void* cube, const void* qxz, const void* qyz, const void* qxy,
                        const void* kidx, void* t1, void* t2, void* d3, int B, int X, int Y,
                        int Z, int C2, int T, void* stream) {
  Args a;
  if (T < 0 || !make_args(a, cube, qxz, qyz, qxy, B, X, Y, Z, C2, Y))
    return (int)cudaErrorInvalidValue;
  return launch(tables_sel_kernel, (long long)B, a, stream, static_cast<const int*>(kidx), T,
                static_cast<int*>(t1), static_cast<int*>(t2), static_cast<int*>(d3));
}

}  // extern "C"
