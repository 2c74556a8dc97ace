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
// exists only because Mosaic's f32 dot is one bf16 pass). No tensor cores.
//
// What bounds it on an H100: the cube read. At the default arena a scan is
// 22*31*176 bf16 = 240,064 bytes against 3*C*120,032 FMAs (C = 3: 2.16 MFLOP),
// so at 3.35 TB/s a batch of 4096 scans needs ~0.30 ms of reads and at the
// 67 TFLOP/s FP32 peak ~0.13 ms of arithmetic. Each SM has to keep ~25 KB of
// cube in flight to draw its share of that rate, and the arithmetic has to
// run without waiting on the loads or on other warps.
//
// What the design does about it (no TPU tiling is carried over):
// - One persistent block per SM walks over scans b = blockIdx.x, +gridDim.x,
//   ... G x-slabs (Y rows of Z values each) at a time. A producer warp keeps
//   a ring of NS stages full: one thread asks for a stage's G slabs by one
//   cp.async.bulk copy and for their template rows txz[c, x.., :] by C more,
//   and the copy engine reports to the stage's full mbarrier. G is as many
//   slabs as fill 32 KB while 3 stages fit (3 at the default arena up to
//   C = 4: ~33 KB of cube a stage; 1 at C >= 6), NS as many stages as the
//   rest of shared memory holds (2 to 8). One slab a stage left the ring at
//   2.6x the bytes bound whatever its depth. The consumer warps release a stage on
//   its empty mbarrier, one arrival per warp. No block barrier is taken
//   after the start.
// - tyz (one bulk copy) and txy stay in shared memory for the block's life;
//   txz travels with the slabs (from L2), so the default arena's templates
//   take 73,656 bytes of shared memory at C = 3, and up to 7 classes fit.
// - W consumer warps (16 up to C = 3, else 8: more warps spill): warp w owns
//   rows y = w, w + W, ...; lane l owns the z pairs l + 32k, read as one
//   bf16x2 word each. Per row the lane FMAs its pairs into m1's partials,
//   into m2's partial of the slab and into its m3 partials.
// - m1: the partials of a warp's first 32 / W rows stay in registers over
//   the scan's slabs and are summed over the warp once per scan (rows beyond
//   those, Y > 32, are summed per slab into shared memory).
// - m2: a warp sums its slab partial over its lanes and leaves it in the
//   stage; when the stage is free again the producer takes the W partials
//   into registers, starts the stage's next copy, then adds them in order
//   and stores m2[b, :, x].
// - m3: the partials stay in registers over the scan. At its end the warps
//   add them to one running sum in shared memory in turn, warp 0 first, each
//   waiting on its own mbarrier for the one before; the last stores m3[b].
//   A warp goes on to the next scan's slabs as soon as its turn is over.
// - No atomics: every sum runs in a fixed order, so the tables are the same
//   bits on every run and for every grid size. Every output element is
//   written exactly once, by a plain store.
// - A cube whose Z is not a multiple of 8, or whose pointers are not 16-byte
//   aligned, goes the same way with the producer warp copying 2-byte values
//   (z padded with zeros to an even count) instead of the copy engine.
// Where it stands (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py and
// utils/kernel_probe.py, PERF.md section 6): 0.9155 ms device at B=4096
// with the demo model's C = 3, against 1.8097 for the kernel it replaces
// (one slab in flight, reductions on every row and slab) and a 0.2969 ms
// bytes bound; 0.0375 ms at B=64 against 0.0787. The copies alone take
// ~0.36 ms; the rows set the pace: a two-row warp spends ~1,800 clocks a
// slab on them, against ~990 shared-memory wavefronts a slab for the SM.
// What it leaves for later: the row loop reads the yz template from shared
// memory for every cube pair (C 8-byte loads per 2 values, 558 of those
// wavefronts at C = 3), the next limit; and a batch of fewer scans than
// SMs leaves SMs idle.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;            // classes the kernel is compiled for
constexpr int kMaxPairs = 4;        // z pairs per lane: Z <= 2 * 32 * kMaxPairs
constexpr int kMaxStages = 8;       // stages the ring holds at most
constexpr int kStageBytes = 32768;  // a stage holds up to this many bytes of cube
constexpr int kWideMaxC = 3;        // 16 consumer warps up to this many classes, else 8
constexpr int kMaxWarps = 16;
constexpr long kSmemMax = 232448;   // one block's dynamic maximum (227 KB)

// Consumer warps of a block at C classes, beside one producer warp: 16 where
// they hold their sums in 96 registers without spilling, else 8.
__host__ __device__ constexpr int warps_for(int C) { return C <= kWideMaxC ? 16 : 8; }
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory carve-up of one block, in 32-bit words (each region a
// multiple of 4 words, so 16-byte aligned). ops/score.py's
// shared_memory_bytes computes the same total.
struct Layout {
  int ZP, ZS, KP;                    // z pairs, padded row (2 ZP), pairs per lane
  int G, NS;                         // x-slabs a stage, stages
  int slab, txz, p2, stage;          // a slab's words; a stage's regions and size
  int bars, tyz, txy, m1, m3, ring;  // region offsets
  long total;                        // bytes
};

// A stage: G x-slabs of one scan (bf16x2 words [g][y][ZP]), their xz
// template rows (float [c][g][ZS]) and their m2 partials (float [g][warp][c]).
__host__ __device__ inline void size_stage(Layout& L, int C, int G) {
  L.G = G;
  L.txz = G * L.slab;
  L.p2 = L.txz + round4(C * G * L.ZS);
  L.stage = L.p2 + round4(G * warps_for(C) * C);
}

__host__ __device__ inline Layout make_layout(int X, int Y, int Z, int C) {
  Layout L;
  L.ZP = (Z + 1) / 2;
  L.ZS = 2 * L.ZP;
  L.KP = (L.ZP + 31) / 32;
  L.slab = round4(Y * L.ZP);
  int off = 0;
  L.bars = off; off += round4(2 * (2 * kMaxStages + 1 + kMaxWarps));  // mbarriers
  L.tyz = off;  off += round4(C * Y * L.ZS);  // float [c][y][ZS], z padded with 0
  L.txy = off;  off += round4(C * X * Y);     // float [c][x][y]
  L.m1 = off;   off += round4(C * Y);         // float [c][y]: rows past the registers
  L.m3 = off;   off += round4(C * L.ZS);      // float [c][ZS]: the warps' running m3
  L.ring = off;
  const long room = kSmemMax / 4 - off;
  // As many slabs a stage as kStageBytes takes (and the producer's lanes
  // cover, G * C <= 32) while 3 stages fit, else 1.
  int G = kStageBytes / (4 * L.slab);
  G = G > 32 / C ? 32 / C : G;
  G = G < 1 ? 1 : (G > X ? X : G);
  size_stage(L, C, G);
  while (G > 1 && 3L * L.stage > room) size_stage(L, C, --G);
  const long ns = room / L.stage;
  L.NS = ns < 2 ? 2 : (ns > kMaxStages ? kMaxStages : (int)ns);
  L.total = 4L * (off + (long)L.NS * L.stage);
  return L;
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
// Wait until the barrier's phase of this parity has completed. A wait of
// more than 10 s traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) __trap();
  }
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
// The consumer warps (not the producer) meet.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

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

// One cube row (ZP words at `cube`) of this lane's pairs into m1's partials
// p (row y, summed over z), m2's partials q (summed over y, z) and the m3
// partials acc3 (per z). tyz_row = tyz[0, y, :] with classes tyz_c apart,
// txy_col = txy[0, x, y] with classes txy_c apart.
template <int C>
__device__ __forceinline__ void row_step(const uint32_t* cube, const float* tyz_row, int tyz_c,
                                         const float* txy_col, int txy_c,
                                         const float2 (&a)[C][kMaxPairs], float (&p)[C],
                                         float (&q)[C], float2 (&acc3)[C][kMaxPairs], int lane,
                                         int KP, int ZP) {
  float t3[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t3[c] = txy_col[c * txy_c];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int pair = lane + 32 * k;
    if (k < KP && pair < ZP) {
      const uint32_t w = cube[pair];
      const float v0 = bf16_lo(w), v1 = bf16_hi(w);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] = fmaf(a[c][k].y, v1, fmaf(a[c][k].x, v0, p[c]));
        const float2 t = *reinterpret_cast<const float2*>(tyz_row + c * tyz_c + 2 * pair);
        q[c] = fmaf(t.y, v1, fmaf(t.x, v0, q[c]));
        acc3[c][k].x = fmaf(t3[c], v0, acc3[c][k].x);
        acc3[c][k].y = fmaf(t3[c], v1, acc3[c][k].y);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(32 * (warps_for(C) + 1), 1)
native_tables_kernel(const uint16_t* __restrict__ cube, const float* __restrict__ txz,
                     const float* __restrict__ tyz, const float* __restrict__ txy,
                     float* __restrict__ m1, float* __restrict__ m2, float* __restrict__ m3,
                     int B, int X, int Y, int Z, int vec) {
  constexpr int W = warps_for(C);
  constexpr int R = 32 / W;  // rows per warp whose m1 partials stay in registers
  constexpr int kConsumers = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = make_layout(X, Y, Z, C);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [stage]: slab landed
  uint64_t* empty = full + kMaxStages;  // [stage]: every consumer warp is done with it
  uint64_t* tmpl = empty + kMaxStages;  // tyz landed
  uint64_t* turn = tmpl + 1;            // [warp]: its turn to add its m3 partials
  float* tyz_s = reinterpret_cast<float*>(smem + L.tyz);
  float* txy_s = reinterpret_cast<float*>(smem + L.txy);
  float* m1_s = reinterpret_cast<float*>(smem + L.m1);
  float* m3_s = reinterpret_cast<float*>(smem + L.m3);
  uint32_t* ring = smem + L.ring;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This block's work units: (scan, group of G x-slabs), scans strided by
  // gridDim.x; unit u goes to stage u % NS.
  const int NG = (X + L.G - 1) / L.G;
  const int nscan = (B - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int U = nscan * NG;
  auto unit_scan = [&](int u) { return (int)(blockIdx.x + (u / NG) * gridDim.x); };
  auto unit_x0 = [&](int u) { return (u % NG) * L.G; };
  auto unit_gx = [&](int u) { return min(L.G, X - unit_x0(u)); };

  if (tid == 0) {
    for (int s = 0; s < L.NS; ++s) {
      mbar_init(&full[s], vec ? 1 : 32);
      mbar_init(&empty[s], W);
    }
    mbar_init(tmpl, 1);
    for (int w = 0; w < W; ++w) mbar_init(&turn[w], 1);
    mbar_arrive(&turn[0]);  // warp 0 starts the first scan's chain
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == W) {
    // The producer warp. When a stage is free again, lane i < G * C takes
    // the consumer warps' m2 partials of its (slab, class) there into
    // registers; they are summed in order and stored once the stage's next
    // copy is under way.
    float part[W];
    auto take = [&](int v) {
      const float* p2 = reinterpret_cast<const float*>(ring + (v % L.NS) * L.stage + L.p2);
      if (lane < unit_gx(v) * C)
#pragma unroll
        for (int w = 0; w < W; ++w) part[w] = p2[(lane / C * W + w) * C + lane % C];
      __syncwarp();
    };
    auto store = [&](int v) {
      if (lane < unit_gx(v) * C) {
        float acc = part[0];
#pragma unroll
        for (int w = 1; w < W; ++w) acc += part[w];
        m2[((size_t)unit_scan(v) * C + lane % C) * X + unit_x0(v) + lane / C] = acc;
      }
    };
    if (vec && lane == 0) {
      const uint32_t tyz_bytes = 4u * C * Y * Z;
      mbar_expect_tx(tmpl, tyz_bytes);
      bulk_copy(tyz_s, tyz, tyz_bytes, tmpl);
    }
    const uint32_t slab_bytes = 2u * Y * Z, row_bytes = 4u * Z;  // on the fast route
    for (int u = 0; u < U; ++u) {
      const int s = u % L.NS, round = u / L.NS;
      if (round > 0) {
        mbar_wait(&empty[s], (round - 1) & 1);
        take(u - L.NS);
      }
      const int x0 = unit_x0(u), gx = unit_gx(u);
      const uint16_t* src = cube + ((size_t)unit_scan(u) * X + x0) * Y * Z;
      uint32_t* st = ring + s * L.stage;
      float* t = reinterpret_cast<float*>(st + L.txz);
      if (vec) {
        if (lane == 0) {
          // the stage's readers have released it; order their reads before
          // the copy engine's writes
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(&full[s], gx * (slab_bytes + C * row_bytes));
          bulk_copy(st, src, gx * slab_bytes, &full[s]);
#pragma unroll
          for (int c = 0; c < C; ++c)
            bulk_copy(t + c * L.G * L.ZS, txz + ((size_t)c * X + x0) * Z, gx * row_bytes,
                      &full[s]);
        }
      } else {
        for (int g = 0; g < gx; ++g) {
          uint16_t* d = reinterpret_cast<uint16_t*>(st + g * L.slab);
          for (int i = lane; i < Y * L.ZS; i += 32) {
            const int y = i / L.ZS, z = i % L.ZS;
            d[i] = z < Z ? src[((size_t)g * Y + y) * Z + z] : uint16_t(0);
          }
        }
        for (int i = lane; i < C * gx * L.ZS; i += 32) {
          const int c = i / (gx * L.ZS), g = i / L.ZS % gx, z = i % L.ZS;
          t[(c * L.G + g) * L.ZS + z] = z < Z ? txz[((size_t)c * X + x0 + g) * Z + z] : 0.f;
        }
        mbar_arrive(&full[s]);  // one arrival per lane, after its own copies
      }
      if (round > 0) store(u - L.NS);
    }
    for (int v = U > L.NS ? U - L.NS : 0; v < U; ++v) {  // the last units' m2
      mbar_wait(&empty[v % L.NS], (v / L.NS) & 1);
      take(v);
      store(v);
    }
    return;
  }

  // The consumer warps. Templates that stay, once per block (tyz by the copy
  // engine on the fast route), overlapping the first slabs.
  if (!vec)
    for (int i = tid; i < C * Y * L.ZS; i += kConsumers) {
      const int z = i % L.ZS;
      tyz_s[i] = z < Z ? tyz[(size_t)(i / L.ZS) * Z + z] : 0.f;
    }
  for (int i = tid; i < C * X * Y; i += kConsumers) txy_s[i] = txy[i];
  for (int i = tid; i < C * Y; i += kConsumers) m1_s[i] = 0.f;
  consumers_sync(kConsumers);
  if (vec) mbar_wait(tmpl, 0);

  float2 acc3[C][kMaxPairs];  // m3 partials of this lane's pairs over the warp's rows
  float p1[R][C];             // m1 partials of the warp's first R rows
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) acc3[c][k] = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) p1[r][c] = 0.f;
  }

  for (int u = 0; u < U; ++u) {
    const int s = u % L.NS, b = unit_scan(u), x0 = unit_x0(u), gx = unit_gx(u);
    mbar_wait(&full[s], (u / L.NS) & 1);  // unit u has landed
    uint32_t* st = ring + s * L.stage;
    for (int g = 0; g < gx; ++g) {
      const int x = x0 + g;
      const uint32_t* slab = st + g * L.slab;
      const float* txz_s = reinterpret_cast<const float*>(st + L.txz) + g * L.ZS;

      float2 a[C][kMaxPairs];  // txz[c, x, this lane's pairs]
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < kMaxPairs; ++k) {
          const int pair = lane + 32 * k;
          a[c][k] = (k < L.KP && pair < L.ZP)
                        ? *reinterpret_cast<const float2*>(txz_s + c * L.G * L.ZS + 2 * pair)
                        : make_float2(0.f, 0.f);
        }
      float q[C];
#pragma unroll
      for (int c = 0; c < C; ++c) q[c] = 0.f;

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int y = warp + r * W;
        if (y < Y)
          row_step<C>(slab + y * L.ZP, tyz_s + y * L.ZS, Y * L.ZS, txy_s + x * Y + y, X * Y, a,
                      p1[r], q, acc3, lane, L.KP, L.ZP);
      }
      for (int y = warp + R * W; y < Y; y += W) {  // rows past the registers (Y > 32)
        float p[C];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = 0.f;
        row_step<C>(slab + y * L.ZP, tyz_s + y * L.ZS, Y * L.ZS, txy_s + x * Y + y, X * Y, a, p,
                    q, acc3, lane, L.KP, L.ZP);
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = warp_sum(p[c]);
        if (lane == 0) {  // this warp owns row y
#pragma unroll
          for (int c = 0; c < C; ++c) m1_s[c * Y + y] += p[c];
        }
      }
      // m2: this warp's partial of the slab goes beside it; the producer sums
      // the warps' partials before it refills the stage.
#pragma unroll
      for (int c = 0; c < C; ++c) q[c] = warp_sum(q[c]);
      if (lane == 0) {
        float* p2 = reinterpret_cast<float*>(st + L.p2);
#pragma unroll
        for (int c = 0; c < C; ++c) p2[(g * W + warp) * C + c] = q[c];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (x0 + gx < X) continue;

    // Scan b is complete. m1: this warp's rows, summed over the warp.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = warp + r * W;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = warp_sum(p1[r][c]);
        p1[r][c] = 0.f;
        if (lane == 0 && y < Y) m1[((size_t)b * C + c) * Y + y] = v;
      }
    }
    if (lane == 0)
      for (int y = warp + R * W; y < Y; y += W)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          m1[((size_t)b * C + c) * Y + y] = m1_s[c * Y + y];
          m1_s[c * Y + y] = 0.f;
        }
    // m3: the warps add their partials to the running sum in turn, warp 0
    // first; the last one stores the result and hands the turn back to
    // warp 0 for the next scan. A warp waits only for the one before it.
    mbar_wait(&turn[warp], (u / NG) & 1);
    float2 run[C][kMaxPairs];  // all loads first, so that they are in flight together
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int pair = lane + 32 * k;
        run[c][k] = (warp > 0 && k < L.KP && pair < L.ZP)
                        ? *reinterpret_cast<const float2*>(m3_s + c * L.ZS + 2 * pair)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int pair = lane + 32 * k;
        if (k < L.KP && pair < L.ZP) {
          float2 v = acc3[c][k];
          if (warp > 0) v = make_float2(run[c][k].x + v.x, run[c][k].y + v.y);
          if (warp < W - 1) {
            *reinterpret_cast<float2*>(m3_s + c * L.ZS + 2 * pair) = v;
          } else {
            float* out = m3 + ((size_t)b * C + c) * Z + 2 * pair;
            out[0] = v.x;
            if (2 * pair + 1 < Z) out[1] = v.y;
          }
        }
        acc3[c][k] = make_float2(0.f, 0.f);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&turn[(warp + 1) % W]);
  }
}

template <int C>
int launch(const void* cube, const void* txz, const void* tyz, const void* txy, void* m1,
           void* m2, void* m3, int B, int X, int Y, int Z, cudaStream_t stream) {
  constexpr int kThreads = 32 * (warps_for(C) + 1);
  const Layout L = make_layout(X, Y, Z, C);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  const int vec = Z % 8 == 0 && ((uintptr_t)cube & 15) == 0 && ((uintptr_t)txz & 15) == 0 &&
                  ((uintptr_t)tyz & 15) == 0;
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
