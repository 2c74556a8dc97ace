// Fused scan->score tables in bf16 for the folded linear pipeline (Hopper, sm_90a).
//
// Replaces the TPU kernel radarml_tpu/ops/pallas_score.py :: fused_native_score
// (body _tables_kernel). For each scan b of a bf16 cube batch v (B, X, Y, Z)
// and float32 class templates txz (C, X, Z), tyz (C, Y, Z), txy (C, X, Y), it
// computes
//
//   m1[b, c, y] = sum_{x,z} txz[c, x, z] * v[b, x, y, z]
//   m2[b, c, x] = sum_{y,z} tyz[c, y, z] * v[b, x, y, z]
//   m3[b, c, z] = sum_{x,y} txy[c, x, y] * v[b, x, y, z]
//
// in float32: bf16 -> float32 is exact, and every product is an FP32 FMA
// against the float32 template (the TPU kernel's bf16 hi/lo template split
// exists only because Mosaic's f32 dot is one bf16 pass).
//
// What bounds it on an H100: the cube read. At the default arena a scan is
// 22*31*176 bf16 = 240,064 bytes against 3*C*120,032 FMAs (C = 3: 2.16 MFLOP),
// so at 3.35 TB/s a batch of 4096 scans needs ~0.30 ms of reads and at the
// 67 TFLOP/s FP32 peak ~0.13 ms of arithmetic. The kernel must read each cube
// byte from device memory once and keep the templates out of device memory.
//
// What the design does about it: no TPU tiling is carried over (no padding of
// the batch to 8 scans or of Y to 16).
// - One persistent block per SM walks over scans b = blockIdx.x, +gridDim.x,
//   ... one x-slab (Y rows of Z values) at a time. The three float32 templates
//   are copied into shared memory once per block and stay there (120,120 bytes
//   at the default arena with C = 3; about 5 classes fit).
// - Slabs are double-buffered: while the block computes slab u, cp.async
//   brings slab u+1 (possibly of the next scan) into the other buffer (16-byte
//   copies; a Z that is not a multiple of 8 takes synchronous 2-byte copies).
// - Warp w owns rows y = w, w + 8, ...; lane l owns the z pairs l + 32k, read
//   as one bf16x2 word each. Per row the lane FMAs its pairs into m1's and
//   m2's partials and into its own m3 accumulators (held in registers over
//   the whole scan); m1's partial is summed over the warp by shuffles and
//   added to the row's shared-memory sum by lane 0, m2's over the warp's rows,
//   then over the warps in order; at the end of the scan the warps add their
//   m3 partials in order, the last one writing the result.
// - No atomics: every sum runs in a fixed order, so the tables are the same
//   bits on every run and for every grid size. Every output element is
//   written exactly once, by plain stores.
// What it leaves for later: the row loop reads the yz template from shared
// memory for every cube pair (C 8-byte loads per 2 values), so shared-memory
// bandwidth, not device memory, is expected to set the pace; wgmma on
// bf16-split templates or register-resident templates are the next steps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;            // classes the kernel is compiled for
constexpr int kMaxPairs = 4;        // z pairs per lane: Z <= 2 * 32 * kMaxPairs
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr long kSmemMax = 232448;   // one block's dynamic maximum (227 KB)

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory carve-up of one block, in 32-bit words (each region a
// multiple of 4 words, so 16-byte aligned). ops/score.py's
// shared_memory_bytes computes the same total.
struct Layout {
  int ZP, ZS, KP;                          // z pairs, padded row (2 ZP), pairs per lane
  int txz, tyz, txy, cube, m1, p2, m3;     // region offsets
  long total;                              // bytes
};

__host__ __device__ inline Layout make_layout(int X, int Y, int Z, int C) {
  Layout L;
  L.ZP = (Z + 1) / 2;
  L.ZS = 2 * L.ZP;
  L.KP = (L.ZP + 31) / 32;
  int off = 0;
  L.txz = off;  off += round4(C * X * L.ZS);   // float [c][x][ZS], z padded with 0
  L.tyz = off;  off += round4(C * Y * L.ZS);   // float [c][y][ZS]
  L.txy = off;  off += round4(C * X * Y);      // float [c][x][y]
  L.cube = off; off += 2 * round4(Y * L.ZP);   // two slabs of bf16x2 words [y][ZP]
  L.m1 = off;   off += round4(C * Y);          // float [c][y], summed over the scan's slabs
  L.p2 = off;   off += round4(kWarps * C);     // float [warp][c], this slab's m2 partials
  L.m3 = off;   off += round4(C * L.ZS);       // float [c][ZS], the warps' running m3
  L.total = 4L * off;
  return L;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// bf16 halves of a word: the lower address (even z) is the low half.
__device__ inline float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The same sum in every lane, in a fixed order (float + is commutative, so
// partners add the same two values).
__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Copy one slab (Y rows of Z bf16 at src) into buf as rows of ZP words.
// `vec` (Z % 8 == 0, 16-byte aligned cube): the slab is Y * Z * 2
// contiguous bytes and ZS == Z, so it goes as 16-byte cp.async copies.
// Otherwise 2-byte synchronous copies, z padded with zeros up to ZS.
__device__ void load_slab(uint32_t* buf, const uint16_t* src, int Y, int Z, int ZS,
                          bool vec) {
  if (vec) {
    const int n16 = Y * Z / 8;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(buf + 4 * i, reinterpret_cast<const int4*>(src) + i);
  } else {
    uint16_t* d = reinterpret_cast<uint16_t*>(buf);
    for (int i = threadIdx.x; i < Y * ZS; i += blockDim.x) {
      const int y = i / ZS, z = i % ZS;
      d[i] = z < Z ? src[(size_t)y * Z + z] : uint16_t(0);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
native_tables_kernel(const uint16_t* __restrict__ cube, const float* __restrict__ txz,
                     const float* __restrict__ tyz, const float* __restrict__ txy,
                     float* __restrict__ m1, float* __restrict__ m2, float* __restrict__ m3,
                     int B, int X, int Y, int Z, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = make_layout(X, Y, Z, C);
  float* txz_s = reinterpret_cast<float*>(smem + L.txz);
  float* tyz_s = reinterpret_cast<float*>(smem + L.tyz);
  float* txy_s = reinterpret_cast<float*>(smem + L.txy);
  float* m1_s = reinterpret_cast<float*>(smem + L.m1);
  float* p2_s = reinterpret_cast<float*>(smem + L.p2);
  float* m3_s = reinterpret_cast<float*>(smem + L.m3);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab_words = round4(Y * L.ZP);

  // This block's work units: (scan, x), scans strided by gridDim.x.
  const int nscan = (B - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int U = nscan * X;
  auto slab_src = [&](int u) {
    const int b = blockIdx.x + (u / X) * gridDim.x;
    return cube + ((size_t)b * X + u % X) * Y * Z;
  };

  if (vec && U > 0) load_slab(smem + L.cube, slab_src(0), Y, Z, L.ZS, true);
  cp_async_commit();
  // Templates, once per block (plain loads, overlapping the first slab).
  for (int i = tid; i < C * X * L.ZS; i += kThreads) {
    const int z = i % L.ZS;
    txz_s[i] = z < Z ? txz[(size_t)(i / L.ZS) * Z + z] : 0.f;
  }
  for (int i = tid; i < C * Y * L.ZS; i += kThreads) {
    const int z = i % L.ZS;
    tyz_s[i] = z < Z ? tyz[(size_t)(i / L.ZS) * Z + z] : 0.f;
  }
  for (int i = tid; i < C * X * Y; i += kThreads) txy_s[i] = txy[i];
  for (int i = tid; i < C * Y; i += kThreads) m1_s[i] = 0.f;

  float2 acc3[C][kMaxPairs];  // m3 partial of this lane's pairs over its warp's rows
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) acc3[c][k] = make_float2(0.f, 0.f);

  for (int u = 0; u < U; ++u) {
    const int b = blockIdx.x + (u / X) * gridDim.x, x = u % X;
    uint32_t* buf = smem + L.cube + (u & 1) * slab_words;
    if (vec) {
      if (u + 1 < U)
        load_slab(smem + L.cube + ((u + 1) & 1) * slab_words, slab_src(u + 1), Y, Z, L.ZS,
                  true);
      cp_async_commit();
      cp_async_wait1();  // slab u has landed (this thread's copies)
    } else {
      load_slab(buf, slab_src(u), Y, Z, L.ZS, false);
    }
    __syncthreads();  // (A) slab u is in buf for everyone

    float2 a_xz[C][kMaxPairs];  // txz[c, x, this lane's pairs]
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int pair = lane + 32 * k;
        a_xz[c][k] = (k < L.KP && pair < L.ZP)
                         ? *reinterpret_cast<const float2*>(txz_s + (c * X + x) * L.ZS + 2 * pair)
                         : make_float2(0.f, 0.f);
      }
    float q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = 0.f;

    for (int y = warp; y < Y; y += kWarps) {
      float p[C], t3[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] = 0.f;
        t3[c] = txy_s[(c * X + x) * Y + y];
      }
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int pair = lane + 32 * k;
        if (k < L.KP && pair < L.ZP) {
          const uint32_t w = buf[y * L.ZP + pair];
          const float v0 = bf16_lo(w), v1 = bf16_hi(w);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float2 a = a_xz[c][k];
            p[c] = fmaf(a.y, v1, fmaf(a.x, v0, p[c]));
            const float2 t = *reinterpret_cast<const float2*>(tyz_s + (c * Y + y) * L.ZS + 2 * pair);
            q[c] = fmaf(t.y, v1, fmaf(t.x, v0, q[c]));
            acc3[c][k].x = fmaf(t3[c], v0, acc3[c][k].x);
            acc3[c][k].y = fmaf(t3[c], v1, acc3[c][k].y);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) p[c] = warp_sum(p[c]);
      if (lane == 0) {  // this warp owns row y
#pragma unroll
        for (int c = 0; c < C; ++c) m1_s[c * Y + y] += p[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = warp_sum(q[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) p2_s[warp * C + c] = q[c];
    }
    __syncthreads();  // (B) row sums and m2 partials complete; buf is free

    if (tid < C) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += p2_s[w * C + tid];
      m2[((size_t)b * C + tid) * X + x] = s;
    }
    if (x == X - 1) {  // the scan is complete: write m1, then m3 warp by warp
      for (int i = tid; i < C * Y; i += kThreads) {
        m1[(size_t)b * C * Y + i] = m1_s[i];
        m1_s[i] = 0.f;
      }
      for (int w = 0; w < kWarps; ++w) {
        if (warp == w) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int k = 0; k < kMaxPairs; ++k) {
              const int pair = lane + 32 * k;
              if (k < L.KP && pair < L.ZP) {
                float2* s = reinterpret_cast<float2*>(m3_s + c * L.ZS + 2 * pair);
                float2 v = acc3[c][k];
                if (w > 0) v = make_float2(s->x + v.x, s->y + v.y);
                if (w < kWarps - 1) {
                  *s = v;
                } else {
                  float* out = m3 + ((size_t)b * C + c) * Z + 2 * pair;
                  out[0] = v.x;
                  if (2 * pair + 1 < Z) out[1] = v.y;
                }
              }
              acc3[c][k] = make_float2(0.f, 0.f);
            }
        }
        __syncthreads();
      }
    }
  }
}

template <int C>
int launch(const void* cube, const void* txz, const void* tyz, const void* txy, void* m1,
           void* m2, void* m3, int B, int X, int Y, int Z, cudaStream_t stream) {
  const Layout L = make_layout(X, Y, Z, C);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  const int vec = Z % 8 == 0 && ((uintptr_t)cube & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(native_tables_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, native_tables_kernel<C>,
                                                           kThreads, L.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < nsm * per_sm ? B : nsm * per_sm;
  native_tables_kernel<C><<<grid, kThreads, L.total, stream>>>(
      static_cast<const uint16_t*>(cube), static_cast<const float*>(txz),
      static_cast<const float*>(tyz), static_cast<const float*>(txy), static_cast<float*>(m1),
      static_cast<float*>(m2), static_cast<float*>(m3), B, X, Y, Z, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes at these dims (exposed so the
// wrapper's own count can be checked against it).
long native_score_smem_bytes(int X, int Y, int Z, int C) {
  return make_layout(X, Y, Z, C).total;
}

// Launch the tables on `stream`: bf16 cube (B, X, Y, Z), float32 templates
// txz (C, X, Z), tyz (C, Y, Z), txy (C, X, Y), all contiguous; float32
// outputs m1 (B, C, Y), m2 (B, C, X), m3 (B, C, Z), every element written.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// shapes the kernel does not take); the launch does not synchronise.
int native_score_tables(const void* cube, const void* txz, const void* tyz, const void* txy,
                        void* m1, void* m2, void* m3, int B, int X, int Y, int Z, int C,
                        void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || Z > 2 * 32 * kMaxPairs || C < 1 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 2: return launch<2>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 3: return launch<3>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 4: return launch<4>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 5: return launch<5>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 6: return launch<6>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    case 7: return launch<7>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
    default: return launch<8>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, s);
  }
}

}  // extern "C"
