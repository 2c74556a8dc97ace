// One-pass int8 contraction tables for the fused predict path (Hopper, sm_90a).
//
// Replaces the TPU kernel radarml_tpu/ops/pallas_i8_score.py ::
// onepass_tables_combined_i8 (body _kernel_combined_zc). For each scan b of
// an int8 cube batch v (B, X, Y, Z) holding value-128, and int8 class
// templates qxz (C2, X, Z), qyz (C2, Y, Z), qxy (C2, X, Y), it computes
//
//   t1[b, c, y] = sum_{x,z} qxz[c, x, z] * v[b, x, y, z]
//   t2[b, c, x] = sum_{y,z} qyz[c, y, z] * v[b, x, y, z]
//   t3[b, z, c] = sum_{x,y} qxy[c, x, y] * v[b, x, y, z]
//
// exactly, in int32. A null template pointer is a masked plane: its table
// comes out zero and its work is skipped.
//
// What bounds it on an H100: the cube read. At the default arena a scan is
// 22*31*176 = 120,032 bytes against ~2.2M int8 MACs for the three tables,
// so at 3.35 TB/s a batch of 4096 scans needs ~0.15 ms of reads; the MACs,
// as dp4a (4 per instruction) fed from shared memory, need about as long.
// So the kernel must read each cube byte from device memory once, keep the
// load in flight while it computes, and not spend its shared-memory
// bandwidth on reloading templates.
//
// What the design does about it: no TPU tiling is carried over (no
// scan-minor layout, y-groups, delta-block weights or lane padding).
// - One persistent block per SM walks over scans b = blockIdx.x, +gridDim.x,
//   ... in x-slabs. All three templates are copied into shared memory once
//   per block and stay there.
// - Slabs are double-buffered: while the block computes slab u, cp.async
//   brings slab u+1 (possibly of the next scan) into the other buffer.
// - t1/t2: one thread per (x, y) row of the slab takes the dot products of
//   the row with its qxz and qyz rows along z with __dp4a, 16 bytes per
//   shared load, and stages them; a second pass sums them over x (t1,
//   accumulated over the scan's slabs in shared memory) and over y (t2,
//   each slab owns its x columns). No atomics.
// - t3: one thread per 4-z word and group of 4-row quads transposes four
//   rows' words with byte permutes so that __dp4a contracts four rows at
//   once against the packed qxy bytes; groups meet in shared atomics.
// - Every output element is written exactly once, by plain stores.
// What limits it now: the row dots read 12 template rows from shared
// memory for every 176-byte cube row (~2.3 KB per row at levels=2), so
// shared-memory bandwidth, not device memory, sets the pace; thread count,
// two blocks per SM, unrolling and splitting z each moved it by about 10%
// on an H100 80GB HBM3 (700 W). The next step is to run the three
// contractions as int8 tensor-core products (mma/wgmma, C2 rows padded to
// 16) with TMA loads; that is left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC2 = 8;      // class rows (levels * classes) per table
constexpr int kThreads = 512;  // one block per SM
constexpr size_t kSmemMax = 232448;  // one block's dynamic maximum (227 KB)

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared-memory carve-up of one block, in 32-bit words (each region a
// multiple of 4 words, so 16-byte aligned). Host and device compute it the
// same way.
struct Layout {
  int XS, nslab, NR, ZV, SW, ZW;
  int qxz, qyz, qxy, cube, P, Q, m1, m3;
  size_t total;  // bytes
};

__host__ __device__ inline Layout make_layout(int XS, int X, int Y, int Z, int C2,
                                              bool h1, bool h2, bool h3) {
  Layout L;
  L.XS = XS;
  L.nslab = (X + XS - 1) / XS;
  L.NR = round_up(XS * Y, 4);  // rows per slab buffer, whole quads
  L.ZV = (Z + 15) / 16;        // 16-byte chunks per row
  L.SW = L.ZV * 4;             // row stride in words
  L.ZW = (Z + 3) / 4;          // 4-z words that hold data
  int off = 0;
  L.qxz = off;  off += h1 ? C2 * X * L.SW : 0;
  L.qyz = off;  off += h2 ? C2 * Y * L.SW : 0;
  L.qxy = off;  off += h3 ? round_up(L.nslab * C2 * L.NR / 4, 4) : 0;
  L.cube = off; off += 2 * L.NR * L.SW;
  L.P = off;    off += h1 ? round_up(C2 * L.NR, 4) : 0;
  L.Q = off;    off += h2 ? round_up(C2 * L.NR, 4) : 0;
  L.m1 = off;   off += round_up(C2 * Y, 4);
  L.m3 = off;   off += L.ZW * 4 * C2;
  L.total = (size_t)off * 4;
  return L;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Copy nrows rows of Z int8 values (row r at src + r * Z) into shared rows
// of SW words, zero-padding z up to SW * 4: 16-byte copies where the rows
// allow (`vec`: Z % 16 == 0 and src 16-byte aligned, so nothing to pad),
// bytes otherwise. `async` issues the 16-byte copies as cp.async.
__device__ void copy_rows(int* dst, const int8_t* src, int nrows, int Z, int SW, bool vec,
                          bool async) {
  if (vec) {
    const int per_row = Z / 16;
    for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
      const int r = i / per_row, k = i % per_row;
      int* d = dst + r * SW + 4 * k;
      const int4* s = reinterpret_cast<const int4*>(src + (size_t)r * Z) + k;
      if (async) cp_async16(d, s);
      else *reinterpret_cast<int4*>(d) = __ldg(s);
    }
  } else {
    int8_t* d = reinterpret_cast<int8_t*>(dst);
    const int Zp = SW * 4;
    for (int i = threadIdx.x; i < nrows * Zp; i += blockDim.x) {
      const int r = i / Zp, z = i % Zp;
      d[i] = z < Z ? src[(size_t)r * Z + z] : int8_t(0);
    }
  }
}

__device__ inline int dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads, 1)
onepass_tables_kernel(const int8_t* __restrict__ cube, const int8_t* __restrict__ qxz,
                      const int8_t* __restrict__ qyz, const int8_t* __restrict__ qxy,
                      int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3,
                      int B, int X, int Y, int Z, int C2, int XS, int vec) {
  extern __shared__ __align__(16) int smem[];
  const bool h1 = qxz != nullptr, h2 = qyz != nullptr, h3 = qxy != nullptr;
  const Layout L = make_layout(XS, X, Y, Z, C2, h1, h2, h3);
  const int tid = threadIdx.x;
  int* qxz_s = smem + L.qxz;
  int* qyz_s = smem + L.qyz;
  int* qxy_s = smem + L.qxy;  // [slab][c][NR / 4] words: 4 rows' bytes each
  int* P = smem + L.P;        // [c][NR]: row dots against qxz
  int* Q = smem + L.Q;        // [c][NR]: row dots against qyz
  int* m1_s = smem + L.m1;    // [c][Y], summed over the scan's slabs
  int* m3_s = smem + L.m3;    // [z][c], z padded to ZW * 4

  // This block's work units: (scan, slab), scans strided by gridDim.x.
  const int nscan = (B - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int U = nscan * L.nslab;
  auto load_unit = [&](int u) {
    const int b = blockIdx.x + (u / L.nslab) * gridDim.x;
    const int x0 = (u % L.nslab) * XS;
    const int xs = min(XS, X - x0);
    int* buf = smem + L.cube + (u & 1) * L.NR * L.SW;
    copy_rows(buf, cube + ((size_t)b * X + x0) * Y * Z, xs * Y, Z, L.SW, vec, vec);
  };

  if (U > 0) load_unit(0);
  cp_async_commit();
  // Templates, once per block (plain loads, overlapping the first unit).
  const bool tvec = Z % 16 == 0;
  if (h1) copy_rows(qxz_s, qxz, C2 * X, Z, L.SW, tvec && ((uintptr_t)qxz & 15) == 0, false);
  if (h2) copy_rows(qyz_s, qyz, C2 * Y, Z, L.SW, tvec && ((uintptr_t)qyz & 15) == 0, false);
  if (h3) {
    int8_t* d = reinterpret_cast<int8_t*>(qxy_s);
    for (int i = tid; i < L.nslab * C2 * L.NR; i += blockDim.x) {
      const int r = i % L.NR, c = (i / L.NR) % C2, s = i / (L.NR * C2);
      const int x0 = s * XS, nr = min(XS, X - x0) * Y;
      d[i] = r < nr ? qxy[((size_t)c * X + x0) * Y + r] : int8_t(0);
    }
  }
  for (int i = tid; i < round_up(C2 * Y, 4) + L.ZW * 4 * C2; i += blockDim.x) m1_s[i] = 0;

  const int NQ = L.NR / 4;
  const int G = max(1, (int)blockDim.x / L.ZW);  // t3 row-quad groups

  for (int u = 0; u < U; ++u) {
    const int b = blockIdx.x + (u / L.nslab) * gridDim.x;
    const int s = u % L.nslab;
    const int x0 = s * XS, xs = min(XS, X - x0), nr = xs * Y;
    if (u + 1 < U) load_unit(u + 1);
    cp_async_commit();
    cp_async_wait1();  // unit u has landed (for this thread's copies)
    __syncthreads();   // (A) ... and for everyone's
    const int* buf = smem + L.cube + (u & 1) * L.NR * L.SW;

    // t1/t2 row dots. Item it -> (y, x): a warp spans few y and many x,
    // so the qyz rows it reads are near-broadcast and its cube rows are
    // a bank-conflict-free stride apart.
    if (h1 || h2) {
      for (int it = tid; it < nr; it += blockDim.x) {
        const int y = it / xs, xl = it % xs, r = xl * Y + y;
        const int4* v = reinterpret_cast<const int4*>(buf + r * L.SW);
        const int4* a = reinterpret_cast<const int4*>(qxz_s + (x0 + xl) * L.SW);
        const int4* q = reinterpret_cast<const int4*>(qyz_s + y * L.SW);
        int d1[kMaxC2], d2[kMaxC2];
#pragma unroll
        for (int c = 0; c < kMaxC2; ++c) d1[c] = d2[c] = 0;
        for (int k = 0; k < L.ZV; ++k) {
          const int4 w = v[k];
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c) {
            if (c < C2) {
              if (h1) d1[c] = dot16(w, a[c * X * L.ZV + k], d1[c]);
              if (h2) d2[c] = dot16(w, q[c * Y * L.ZV + k], d2[c]);
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

    // t3: item -> (4-z word zw, quad group g), taken from the top thread
    // down so that threads with no row above start here at once.
    if (h3) {
      const int* qw = qxy_s + s * C2 * NQ;
      for (int it = blockDim.x - 1 - tid; it < L.ZW * G; it += blockDim.x) {
        const int zw = it % L.ZW, g = it / L.ZW;
        int acc[4][kMaxC2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kMaxC2; ++c) acc[i][c] = 0;
        for (int qd = g; qd * 4 < nr; qd += G) {
          const int* row = buf + qd * 4 * L.SW + zw;
          const int w0 = row[0], w1 = row[L.SW], w2 = row[2 * L.SW], w3 = row[3 * L.SW];
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
              const int qc = qw[c * NQ + qd];
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
    __syncthreads();  // (B) row dots and m3 partials complete; buf is free

    // t1 += sum over this slab's x; t2 for this slab's x columns.
    if (h1)
      for (int i = tid; i < C2 * Y; i += blockDim.x) {
        const int c = i / Y, y = i % Y;
        int acc = 0;
        for (int xl = 0; xl < xs; ++xl) acc += P[c * L.NR + xl * Y + y];
        m1_s[i] += acc;
      }
    for (int i = tid; i < C2 * xs; i += blockDim.x) {
      const int c = i / xs, xl = i % xs;
      int acc = 0;
      if (h2)
        for (int y = 0; y < Y; ++y) acc += Q[c * L.NR + xl * Y + y];
      t2[((size_t)b * C2 + c) * X + x0 + xl] = acc;
    }
    if (s == L.nslab - 1) {  // the scan is complete: write and clear
      for (int i = tid; i < C2 * Y; i += blockDim.x) {
        t1[(size_t)b * C2 * Y + i] = m1_s[i];
        m1_s[i] = 0;
      }
      for (int i = tid; i < L.ZW * 4 * C2; i += blockDim.x) {
        if (i < Z * C2) t3[(size_t)b * Z * C2 + i] = m3_s[i];
        m3_s[i] = 0;
      }
    }
  }
}

// The x-slab width: the widest, balanced over the slabs, whose block fits
// the shared-memory maximum; 0 if no slab fits.
int slab_width(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  for (int XS = X; XS >= 1; --XS) {
    if (make_layout(XS, X, Y, Z, C2, h1, h2, h3).total <= kSmemMax) {
      const int nslab = (X + XS - 1) / XS;
      return (X + nslab - 1) / nslab;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// The x-slab width a launch uses (exposed so the wrapper can report it).
int i8_score_slab_width(int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return slab_width(X, Y, Z, C2, h1, h2, h3);
}

// Launch the one-pass tables on `stream`. Outputs are scan-major int32
// t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2), every element written.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for shapes the kernel does not take); the launch does not synchronise.
int i8_score_onepass_tables(const void* cube, const void* qxz, const void* qyz,
                            const void* qxy, void* t1, void* t2, void* t3, int B,
                            int X, int Y, int Z, int C2, void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C2 < 1 || C2 > kMaxC2)
    return (int)cudaErrorInvalidValue;
  const bool h1 = qxz, h2 = qyz, h3 = qxy;
  const int XS = slab_width(X, Y, Z, C2, h1, h2, h3);
  if (XS == 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(XS, X, Y, Z, C2, h1, h2, h3);
  const int vec = Z % 16 == 0 && ((uintptr_t)cube & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      onepass_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onepass_tables_kernel,
                                                           kThreads, L.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < nsm * per_sm ? B : nsm * per_sm;
  onepass_tables_kernel<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cube), static_cast<const int8_t*>(qxz),
      static_cast<const int8_t*>(qyz), static_cast<const int8_t*>(qxy),
      static_cast<int*>(t1), static_cast<int*>(t2), static_cast<int*>(t3), B, X, Y, Z, C2,
      XS, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
