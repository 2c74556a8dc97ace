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
// What bounds it on an H100: operations. At the serving shape (16,384
// queries x 1,823 support vectors x 10,010 features) it does 2*n*m*F ~
// 6.0e11 flops against 0.73 GB of reads, ~800 flops a byte. Outside the
// tensor cores the card does 67 TFLOP/s of FP32 FMAs (8.9 ms at least);
// the tensor cores do 495 TFLOP/s of TF32 products, and a float32 product
// is three TF32 products, so the least time by the fastest float32-grade
// route is 3.64 ms. A float32 Gram has to keep float32's digits, because
// |x|^2 + |s|^2 - 2<x,s> cancels for near points; one TF32 product keeps
// only 11 bits of each factor.
//
// What the design does about it:
// - 3xTF32. Each float32 a is split into hi = tf32(a), round to nearest, and
//   lo = a - hi (exact), and <x,s> is summed as lo*hi + hi*lo + hi*hi by
//   wgmma.mma_async m64n128k8 tf32 with float32 accumulation; lo*lo (2^-22
//   of a product) is dropped.
// - Three launches per call. Two pack passes (one warp a row) rewrite the
//   operands into tiles the main kernel can fetch with one bulk copy each:
//   X as float32 tiles of 128 rows x 32 columns, S split into hi and lo
//   tiles, both zero-padded to whole tiles and already in the 128-byte
//   swizzled layout wgmma reads, and |x|^2, |s|^2 summed in double from
//   the float32 values in the same pass (lanes in a fixed order). The pack
//   reads any contiguous float32 rows with scalar loads, so rows 40,040
//   bytes apart, an odd F or a view that starts mid-buffer need no other
//   path, and ragged n, m, F are padded on the way; its time (X is read and
//   written once more) is counted in the kernel's. X stays float32 in
//   device memory and is split in registers, so the big operand moves 4
//   bytes a value; S, small and reused by every row tile, moves 8. Loading
//   X as it lies with 4- or 8-byte cp.async was not built.
// - The main kernel is persistent: one block per SM walks 128 x 128 output
//   tiles, column tiles fastest, so the blocks in flight share a few row
//   tiles of X and all of S through L2. A block is three warpgroups: one
//   thread of the producer warpgroup keeps a ring of 3 stages (32 columns
//   of F: 16 KB of X, 32 KB of S hi and lo) filled by cp.async.bulk,
//   signalled through mbarriers; each of the two consumer warpgroups owns
//   64 rows of the tile, reads its A fragments from shared memory
//   (conflict-free under the swizzle), splits them, and queues the twelve
//   wgmma of a stage (A from registers, B by descriptor). TF32 wgmma takes K-major operands
//   only, which is how row-major X and S already lie: no transposing stage.
// - Precision. The tensor core's float32 accumulation truncates what it
//   adds to a large accumulator, so it only ever sums one stage (32 columns)
//   from zero, the eight small terms first; each stage's tile is added round
//   to nearest to a tile in registers (second level), which every 20 stages
//   joins the running tile in shared memory (third level, 64 KB: three tiles
//   do not fit the registers). With the terms of a k-step side by side
//   instead, equal rows of 10,010 uniform values came out 3.00e-04 off in K
//   at gamma 0.1 against 2.50e-04 this way; summing only one k-step (8
//   columns) from zero gave 2.19e-04 but took 5.86 ms against 4.63, because
//   of four times the adds (radarml_tpu_torch/utils/kernel_probe.py, NVIDIA
//   H100 80GB HBM3, 700.00 W). The
//   epilogue forms xx + ss - 2g in double from the double norms, clamps at
//   0, rounds to float and applies expf (not __expf) before the single
//   store; edges outside (n, m) are not stored.
// Where it stands (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py and
// kernel_probe.py): PERF.md section 6 has the times of a call (the main
// kernel and the two pack passes) at the serving and training shapes beside
// the FP32-FMA kernel this one replaces (21.75 and 3.00 ms) and the plain
// version. What holds the main kernel above the 3xTF32 bound: the
// consumers' adds and splits do not overlap the tensor core's work. A
// consumer warp's instructions add to the clocks of its wgmma instead of
// hiding behind them (without the adds, with one wgmma instead of three and
// without the loads the probe shows what each costs), whether or not the
// warpgroups take turns at the tensor core (named barriers: no gain), so
// each instruction a consumer warp is spared counts.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // output rows and columns per block
constexpr int kChunk = 32;    // F columns per stage: one 128-byte swizzled row
constexpr int kStages = 3;    // ring of stages in shared memory
constexpr int kGroup = 20;    // stages summed in registers before they join the running tile
constexpr int kThreads = 384; // two consumer warpgroups and the producer's
constexpr int kTileFloats = kTile * kChunk;           // one operand tile of a stage
constexpr int kABytes = kTileFloats * 4;              // X tile, float32
constexpr int kBBytes = 2 * kTileFloats * 4;          // S tile, hi then lo
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kRunBytes = kTile * kTile * 4;           // the running tile
constexpr int kSmemBytes = kStages * kStageBytes + kRunBytes + 1024;  // + room to align
constexpr int kPackThreads = 256;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Float index of element (row, col) inside a 128 x 32 tile in the 128-byte
// swizzle: the 16-byte group g of row r lies at group g ^ (r % 8).
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kChunk + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Pack pass: warp w rewrites row w of A (rows, F) into tile images of
// [row tile][chunk] and writes the row's squared norm. kSplit: each chunk
// holds a hi tile then a lo tile (TF32 values); otherwise one float32 tile.
// Rows >= rows and columns >= F are written as zeros.
template <bool kSplit>
__global__ void __launch_bounds__(kPackThreads)
    rbf_pack_kernel(const float* __restrict__ A, int rows, int rows_padded, int F, int nchunks,
                    float* __restrict__ img, double* __restrict__ norms) {
  const int row = blockIdx.x * (kPackThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_padded) return;
  constexpr int per_chunk = (kSplit ? 2 : 1) * kTileFloats;
  const bool live = row < rows;
  const float* src = A + (size_t)row * F;
  float* dst = img + (size_t)(row / kTile) * nchunks * per_chunk + swizzled(row % kTile, lane);
  double acc = 0.0;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c) {
    const int col = c * kChunk + lane;
    const float v = (live && col < F) ? src[col] : 0.f;
    acc = fma((double)v, (double)v, acc);
    if (kSplit) {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      dst[(size_t)c * per_chunk] = __uint_as_float(hi);
      dst[(size_t)c * per_chunk + kTileFloats] = __uint_as_float(lo);
    } else {
      dst[(size_t)c * per_chunk] = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) norms[row] = acc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread copies `bytes` contiguous bytes (16-byte aligned, a multiple
// of 16) from device memory to shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: groups of 8 rows lie 1024 bytes apart.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (not used by this layout)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// d (64 x 128, float32) = or += A (64 x 8, TF32, registers) * B^T (128 x 8,
// TF32, shared memory by descriptor).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// The compiler must not move reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_tile(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragment of one k-step, split: element i is row r0 + 8 * (i % 2),
// column 8 * ks + t + 4 * (i / 2) of the stage's X tile. `As` points at row
// r0, column t of the tile; off0 / off1 are the swizzled float offsets of the
// 16-byte groups 2 * ks and 2 * ks + 1 in rows r0 and r0 + 8.
struct Fragment {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void load_fragment(Fragment& f, const float* As, int off0, int off1) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = As[8 * (i & 1) * kChunk + ((i >> 1) ? off1 : off0)];
    // hi = tf32(v), round to nearest, ties away (cvt.rna.tf32.f32 on finite
    // values), done on the bits; lo = v - hi is exact and keeps its low
    // bits, which the tensor core drops (2^-11 of lo, either sign). Two
    // instructions a value where cvt.rna costs five: the consumers' adds
    // and splits do not hide behind the tensor core, so each one counts.
    f.hi[i] = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    f.lo[i] = __float_as_uint(v - __uint_as_float(f.hi[i]));
  }
}

// Queue a stage (four k-steps of 8 columns of F) on the tensor core as one
// group: acc = sum of lo * hi + hi * lo, then + hi * hi, from zero. The
// eight small terms go first: the tensor core truncates what it adds to a
// large accumulator, and this way only the last three hi * hi meet one.
__device__ __forceinline__ void queue_stage(float (&acc)[64], const Fragment (&f)[4],
                                            uint64_t b_hi, uint64_t b_lo) {
  fence_tile(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t k_off = (uint64_t)((ks * 8 * 4) >> 4);  // 8 columns on, in 16 bytes
    wgmma_m64n128k8(acc, f[ks].lo[0], f[ks].lo[1], f[ks].lo[2], f[ks].lo[3], b_hi + k_off,
                    ks > 0);
    wgmma_m64n128k8(acc, f[ks].hi[0], f[ks].hi[1], f[ks].hi[2], f[ks].hi[3], b_lo + k_off, 1);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t k_off = (uint64_t)((ks * 8 * 4) >> 4);
    wgmma_m64n128k8(acc, f[ks].hi[0], f[ks].hi[1], f[ks].hi[2], f[ks].hi[3], b_hi + k_off, 1);
  }
  wgmma_commit();
}

// Add a finished stage to the second level, round to nearest.
__device__ __forceinline__ void retire_stage(float (&acc)[64], float (&mid)[64]) {
  fence_tile(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) mid[i] += acc[i];
}

__global__ void __launch_bounds__(kThreads, 1)
    rbf_gram_kernel(const float* __restrict__ Ximg, const float* __restrict__ Simg,
                    const double* __restrict__ xx, const double* __restrict__ ss,
                    float* __restrict__ out, int n, int m, int nchunks, int col_tiles,
                    int ntiles, float gamma) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // Stage s: X tile at ring + s * kStageBytes, then S hi, then S lo; each
  // tile starts on a 1024-byte boundary, as the swizzle needs.
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);                // the producer's arrive + the bytes
      mbar_init(&empty_bar[s], 2 * kTile);       // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const float* a = Ximg + (size_t)(tile / col_tiles) * nchunks * kTileFloats;
        const float* b = Simg + (size_t)(tile % col_tiles) * nchunks * (2 * kTileFloats);
        for (int c = 0; c < nchunks; ++c) {
          mbar_wait(&empty_bar[stage], phase ^ 1u);  // passes at once on the first lap
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full_bar[stage], kStageBytes);
          bulk_copy(st, a + (size_t)c * kTileFloats, kABytes, &full_bar[stage]);
          bulk_copy(st + kABytes, b + (size_t)c * (2 * kTileFloats), kBBytes, &full_bar[stage]);
          if (++stage == kStages) { stage = 0; phase ^= 1u; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 * wg .. + 63 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 64 * wg + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
    int stage = 0;
    uint32_t phase = 0;
    float* run_s = reinterpret_cast<float*>(ring + kStages * kStageBytes) + threadIdx.x;
    // part: a stage's products, summed by the tensor core from zero; mid
    // collects kGroup of them round to nearest before they join the running
    // tile. While this warpgroup adds, the tensor core has the other's stage.
    float part[64], mid[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = mid[i] = 0.f;
    auto join_running = [&](bool first) {  // third level
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        run_s[i * (2 * kTile)] = first ? mid[i] : run_s[i * (2 * kTile)] + mid[i];
        mid[i] = 0.f;
      }
    };

    int off[8];  // swizzled float offset of 16-byte group j in this thread's rows
#pragma unroll
    for (int j = 0; j < 8; ++j) off[j] = (j ^ g) << 2;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(&full_bar[stage], phase);
        const uint8_t* st = ring + stage * kStageBytes;
        const float* As = reinterpret_cast<const float*>(st) + r0 * kChunk + t;
        const uint64_t b_hi = tile_desc(smem_u32(st + kABytes));
        const uint64_t b_lo = tile_desc(smem_u32(st + kABytes + kABytes));
        Fragment f[4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) load_fragment(f[ks], As, off[2 * ks], off[2 * ks + 1]);
        queue_stage(part, f, b_hi, b_lo);
        wgmma_wait<0>();
        retire_stage(part, mid);
        mbar_arrive(&empty_bar[stage]);  // this thread is done with the stage
        if (++stage == kStages) { stage = 0; phase ^= 1u; }
        if (c % kGroup == kGroup - 1 || c == nchunks - 1) join_running(c < kGroup);
      }

      // Epilogue: element 4 j + i of the tile is row r0 + 8 * (i / 2),
      // column 8 * j + 2 * t + i % 2.
      const int row0 = (tile / col_tiles) * kTile, col0 = (tile % col_tiles) * kTile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + r0 + 8 * h;
        if (gr >= n) continue;
        const double xr = xx[gr];
        float* orow = out + (size_t)gr * m;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gc = col0 + 8 * j + 2 * t + e;
            if (gc >= m) continue;
            const double gdot = run_s[(4 * j + 2 * h + e) * (2 * kTile)];
            const float d2 = (float)fmax(xr + ss[gc] - 2.0 * gdot, 0.0);
            orow[gc] = expf(-gamma * d2);
          }
      }
    }
  }
}

struct Workspace {
  int row_tiles, col_tiles, nchunks;
  size_t ximg, simg, xx, ss, total;  // byte offsets and total bytes
};

inline Workspace workspace(int n, int m, int F) {
  Workspace w;
  w.row_tiles = ceil_div(n, kTile);
  w.col_tiles = ceil_div(m, kTile);
  w.nchunks = ceil_div(F, kChunk);
  w.ximg = 0;
  w.simg = w.ximg + (size_t)w.row_tiles * w.nchunks * kABytes;
  w.xx = w.simg + (size_t)w.col_tiles * w.nchunks * kBBytes;
  w.ss = w.xx + (size_t)w.row_tiles * kTile * sizeof(double);
  w.total = w.ss + (size_t)w.col_tiles * kTile * sizeof(double);
  return w;
}

inline bool takes(int n, int m, int F) {
  return n >= 1 && m >= 1 && F >= 1 && n <= (1 << 24) && m <= (1 << 24) &&
         (long long)ceil_div(n, kTile) * ceil_div(m, kTile) < (1ll << 31);
}

}  // namespace

extern "C" {

// Bytes of scratch a launch needs for the packed operands and the norms
// (0 for shapes the kernel does not take).
size_t rbf_gram_workspace_bytes(int n, int m, int F) {
  return takes(n, m, F) ? workspace(n, m, F).total : 0;
}

// Launch the fused Gram matrix on `stream`: out (n, m) row-major float32
// from contiguous row-major float32 X (n, F) and S (m, F), any alignment.
// `work` is device scratch of at least rbf_gram_workspace_bytes(n, m, F)
// bytes, 16-byte aligned. Three kernels are queued (pack X, pack S, the
// Gram). Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for shapes it does not take); nothing synchronises.
int rbf_gram_f32(const void* X, const void* S, void* out, void* work, size_t work_bytes, int n,
                 int m, int F, float gamma, void* stream) {
  if (!takes(n, m, F)) return (int)cudaErrorInvalidValue;
  const Workspace w = workspace(n, m, F);
  if (work == nullptr || work_bytes < w.total || ((uintptr_t)work & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* base = static_cast<uint8_t*>(work);
  float* ximg = reinterpret_cast<float*>(base + w.ximg);
  float* simg = reinterpret_cast<float*>(base + w.simg);
  double* xx = reinterpret_cast<double*>(base + w.xx);
  double* ss = reinterpret_cast<double*>(base + w.ss);

  int dev = 0, nsm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(rbf_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes)) != cudaSuccess)
    return (int)err;

  constexpr int rows_per_block = kPackThreads / 32;
  const int xrows = w.row_tiles * kTile, srows = w.col_tiles * kTile;
  rbf_pack_kernel<false><<<ceil_div(xrows, rows_per_block), kPackThreads, 0, st>>>(
      static_cast<const float*>(X), n, xrows, F, w.nchunks, ximg, xx);
  rbf_pack_kernel<true><<<ceil_div(srows, rows_per_block), kPackThreads, 0, st>>>(
      static_cast<const float*>(S), m, srows, F, w.nchunks, simg, ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int ntiles = w.row_tiles * w.col_tiles;
  const int grid = ntiles < nsm ? ntiles : nsm;
  rbf_gram_kernel<<<grid, kThreads, kSmemBytes, st>>>(ximg, simg, xx, ss,
                                                      static_cast<float*>(out), n, m, w.nchunks,
                                                      w.col_tiles, ntiles, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
