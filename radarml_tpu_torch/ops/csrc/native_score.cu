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
// - On the default instance a cube whose Z is not a multiple of 8, or
//   whose pointers are not 16-byte aligned, goes the same way with the
//   producer warp copying 2-byte values (z padded with zeros to an even
//   count) instead of the copy engine.
// - The work plan (make_plan). One launch takes C <= 8 classes (a template
//   argument) and a z-chunk of at most 256 values (a lane's pairs stay in
//   registers, kMaxPairs) whose templates fit a block. Past that the host
//   cuts Z into chunks (176 and 175 at Z = 351) and the classes into
//   groups (4 + 4 at C = 8 on the default arena, 5 + 4 at 9, 6 + 6 + 4 at
//   16), one launch each, the chunks one after another on the stream: a
//   launch writes its group's m3 rows of its chunk and, after the first
//   chunk, adds its m1 and m2 sums to the ones before it, so every sum still
//   runs in a fixed order. A chunk's rows are not contiguous in the cube, so
//   it takes the copy route. Every chunk reads its own z of the cube; every
//   class group reads the whole cube again (from L2 where the groups' blocks
//   run close together). At the default arena with up to 7 classes the plan
//   is one launch, the kernel as it was. What is left refused: one class at
//   8 z values not fitting a block, i.e. the txy template (X * Y floats)
//   near 227 KB.
// - The long-row instance (kLong: a z-chunk past 256 values, up to 384, at
//   most 3 classes a launch). Where Z needs more than one chunk of the
//   default instance but fits 6 pairs a lane, the plan takes one chunk of
//   Z in groups of up to 3 classes instead, when that makes no more
//   launches (at 43 x 31 x 351 with 3 classes: one launch where there were
//   two). Its rows need not be whole 16-byte units or aligned: the
//   producer asks the copy engine for the 16-byte aligned run of device
//   memory around a stage's G slabs (one cp.async.bulk, whatever Z and the
//   cube's alignment), and for the runs around each class's txz rows and
//   txy values of those slabs (txy travels with the slabs, so the yz
//   template of 3 classes at Y = 31, Z = 351 fits beside a 3-stage ring);
//   the consumers read past each run's lead. With Z odd every other row
//   starts at an odd bf16 value: a lane's pair is then the high half of one
//   word and the low half of the next, and the value past the row's end is
//   taken as zero. No 2-byte copy runs on this route; tyz is loaded once a
//   block by the consumer warps. 15 consumer warps beside the producer
//   (512 threads) leave 128 registers a thread for a lane's 6 pairs of
//   sums; 16 capped them at 96 and spilled.
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
// SMs leaves SMs idle. At 43 x 31 x 351 with 3 classes the long-row
// instance takes 4.38 ms at B=4096 (one launch; a 1.1505 ms bytes bound),
// against 58.4 ms for the two z-chunk launches of the copy route it
// replaces there; the copies alone take 1.40 ms, the rows ~5,000 clocks a
// slab (utils/kernel_probe.py native).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;            // classes the kernel is compiled for
constexpr int kMaxPairs = 4;        // z pairs per lane: Z <= 2 * 32 * kMaxPairs
constexpr int kLongPairs = 6;       // the long-row instance's: Z <= 2 * 32 * kLongPairs
constexpr int kLongMaxC = 3;        // classes a long-row launch takes
constexpr int kLongWarps = 15;      // its consumer warps: 512 threads, 128 registers each
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
  int zw, yw, sxy;                   // long rows: a class's txz and txy words a stage; txy's start
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

// A stage of the long-row instance: the 16-byte aligned run of device memory
// that holds its G x-slabs (a bulk copy may start up to 14 bytes early and
// end up to 15 late; a row's last pair may read one word past), and per
// class such a run of its txz rows (G * Z floats) and of its txy values
// (G * Y floats), then the m2 partials.
__host__ __device__ inline void size_stage_long(Layout& L, int C, int Y, int Z, int G) {
  L.G = G;
  L.zw = round4(G * Z + 8);
  L.yw = round4(G * Y + 8);
  L.txz = round4((2 * G * Y * Z + 30) / 4 + 2);
  L.sxy = L.txz + C * L.zw;
  L.p2 = L.sxy + C * L.yw;
  L.stage = L.p2 + round4(G * kLongWarps * C);
}

// `lng`: the long-row instance, whose txy travels with the slabs.
__host__ __device__ inline Layout make_layout(int X, int Y, int Z, int C, bool lng = false) {
  Layout L;
  L.ZP = (Z + 1) / 2;
  L.ZS = 2 * L.ZP;
  L.KP = (L.ZP + 31) / 32;
  L.slab = round4(Y * L.ZP);
  int off = 0;
  L.bars = off; off += round4(2 * (2 * kMaxStages + 1 + kMaxWarps));  // mbarriers
  L.tyz = off;  off += round4(C * Y * L.ZS);  // float [c][y][ZS], z padded with 0
  L.txy = off;  off += lng ? 0 : round4(C * X * Y);  // float [c][x][y]
  L.m1 = off;   off += round4(C * Y);         // float [c][y]: rows past the registers
  L.m3 = off;   off += round4(C * L.ZS);      // float [c][ZS]: the warps' running m3
  L.ring = off;
  const long room = kSmemMax / 4 - off;
  // As many slabs a stage as kStageBytes takes (and the producer's lanes
  // cover, G * C <= 32) while 3 stages fit, else 1.
  int G = kStageBytes / (4 * L.slab);
  G = G > 32 / C ? 32 / C : G;
  G = G < 1 ? 1 : (G > X ? X : G);
  if (lng) {
    size_stage_long(L, C, Y, Z, G);
    while (G > 1 && 3L * L.stage > room) size_stage_long(L, C, Y, Z, --G);
  } else {
    size_stage(L, C, G);
    while (G > 1 && 3L * L.stage > room) size_stage(L, C, --G);
  }
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
// The 16-byte aligned run of device memory that holds the n bytes at p: its
// start, and its length (a multiple of 16) as the result.
__device__ __forceinline__ uint32_t superset(const void* p, uint32_t n, const void*& start) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), a0 = a & ~uintptr_t(15);
  start = reinterpret_cast<const void*>(a0);
  return (uint32_t)(((a + n + 15) & ~uintptr_t(15)) - a0);
}
// Where the n bytes at p begin in their superset run, in units of `unit` bytes.
__device__ __forceinline__ int lead(const void* p, int unit) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15) / unit;
}

// The consumer warps (not the producer) meet.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The copy route's loads: rows of Z values (row r at src + r * ZT) into
// rows of ZS (zero past Z) at dst, by the 32 lanes of one warp, each lane's
// 16 loads of a round issued before any of its stores so that they are in
// flight together.
template <class T>
__device__ __forceinline__ void copy_padded(T* dst, const T* src, int rows, int Z, int ZT, int ZS,
                                            int lane) {
  constexpr int kInFlight = 16;
  const int n = rows * ZS;
  for (int i0 = lane; i0 < n; i0 += 32 * kInFlight) {
    T v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = i0 + 32 * k, r = i / ZS, z = i % ZS;
      v[k] = i < n && z < Z ? src[(size_t)r * ZT + z] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (i0 + 32 * k < n) dst[i0 + 32 * k] = v[k];
  }
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
template <int C, int KM>
__device__ __forceinline__ void row_step(const uint32_t* cube, const float* tyz_row, int tyz_c,
                                         const float* txy_col, int txy_c,
                                         const float2 (&a)[C][KM], float (&p)[C],
                                         float (&q)[C], float2 (&acc3)[C][KM], int lane,
                                         int KP, int ZP) {
  float t3[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t3[c] = txy_col[c * txy_c];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
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

// row_step on the long-row route: the row starts at bf16 value e of the
// stage's cube words, which is odd for every other row when Z is odd; then
// a lane's pair straddles two words (the high half of one, the low half of
// the next). The value past the row's end (Z odd) is taken as zero: it is
// the next row's first or the copy's padding. t3 holds txy[c, x, y].
template <int C>
__device__ __forceinline__ void row_step_long(const uint32_t* words, int e, const float* tyz_row,
                                              int tyz_c, const float (&t3)[C],
                                              const float2 (&a)[C][kLongPairs], float (&p)[C],
                                              float (&q)[C], float2 (&acc3)[C][kLongPairs],
                                              int lane, int KP, int ZP, int Z) {
  const uint32_t* w = words + (e >> 1);
  const bool odd = e & 1;
#pragma unroll
  for (int k = 0; k < kLongPairs; ++k) {
    const int j = lane + 32 * k;
    if (k < KP && j < ZP) {
      float v0, v1;
      if (odd) {
        v0 = bf16_hi(w[j]);
        v1 = bf16_lo(w[j + 1]);
      } else {
        const uint32_t u = w[j];
        v0 = bf16_lo(u);
        v1 = bf16_hi(u);
      }
      if (2 * j + 1 >= Z) v1 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] = fmaf(a[c][k].y, v1, fmaf(a[c][k].x, v0, p[c]));
        const float2 t = *reinterpret_cast<const float2*>(tyz_row + c * tyz_c + 2 * j);
        q[c] = fmaf(t.y, v1, fmaf(t.x, v0, q[c]));
        acc3[c][k].x = fmaf(t3[c], v0, acc3[c][k].x);
        acc3[c][k].y = fmaf(t3[c], v1, acc3[c][k].y);
      }
    }
  }
}

// One launch takes C classes and a z-chunk of Z values: the cube, txz and
// tyz pointers start at the chunk's first z, their rows ZT values apart (the
// arena's Z); txz, tyz, txy start at the launch's first class and m1, m2, m3
// at its first row of CT classes a scan (m3 also at the chunk's first z).
// With `accum` the launch adds its m1 and m2 sums to what is there: the
// chunks run one after another on one stream, so every sum still runs in a
// fixed order. kLong: the long-row instance (one z-chunk of up to 384
// values, any alignment; its launches take vec = 1).
template <int C, bool kLong>
__global__ void __launch_bounds__(32 * ((kLong ? kLongWarps : warps_for(C)) + 1), 1)
native_tables_kernel(const uint16_t* __restrict__ cube, const float* __restrict__ txz,
                     const float* __restrict__ tyz, const float* __restrict__ txy,
                     float* __restrict__ m1, float* __restrict__ m2, float* __restrict__ m3,
                     int B, int X, int Y, int Z, int vec, int ZT, int CT, int accum) {
  constexpr int W = kLong ? kLongWarps : warps_for(C);
  constexpr int R = 32 / W;  // rows per warp whose m1 partials stay in registers
  constexpr int kConsumers = 32 * W;
  constexpr int KM = kLong ? kLongPairs : kMaxPairs;
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = make_layout(X, Y, Z, C, kLong);
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
        float* out = m2 + ((size_t)unit_scan(v) * CT + lane % C) * X + unit_x0(v) + lane / C;
        *out = accum ? *out + acc : acc;
      }
    };
    if (vec && !kLong && lane == 0) {
      const uint32_t tyz_bytes = 4u * C * Y * Z;
      mbar_expect_tx(tmpl, tyz_bytes);
      bulk_copy(tyz_s, tyz, tyz_bytes, tmpl);
    }
    const uint32_t slab_bytes = 2u * Y * Z, row_bytes = 4u * Z;  // on the fast route (ZT == Z)
    for (int u = 0; u < U; ++u) {
      const int s = u % L.NS, round = u / L.NS;
      if (round > 0) {
        mbar_wait(&empty[s], (round - 1) & 1);
        take(u - L.NS);
      }
      const int x0 = unit_x0(u), gx = unit_gx(u);
      const uint16_t* src = cube + ((size_t)unit_scan(u) * X + x0) * Y * ZT;
      uint32_t* st = ring + s * L.stage;
      float* t = reinterpret_cast<float*>(st + L.txz);
      if (kLong) {
        // The 16-byte aligned runs that hold the G slabs, and each class's
        // txz rows and txy values of them, by the copy engine whatever Z
        // and the alignment; the consumers read past the runs' lead.
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const void* from[1 + 2 * C];
          uint32_t bytes[1 + 2 * C], total = 0;
          bytes[0] = superset(src, 2u * gx * Y * Z, from[0]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            bytes[1 + c] = superset(txz + ((size_t)c * X + x0) * Z, 4u * gx * Z, from[1 + c]);
            bytes[1 + C + c] =
                superset(txy + ((size_t)c * X + x0) * Y, 4u * gx * Y, from[1 + C + c]);
          }
#pragma unroll
          for (int i = 0; i < 1 + 2 * C; ++i) total += bytes[i];
          mbar_expect_tx(&full[s], total);
          bulk_copy(st, from[0], bytes[0], &full[s]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            bulk_copy(t + c * L.zw, from[1 + c], bytes[1 + c], &full[s]);
            bulk_copy(st + L.sxy + c * L.yw, from[1 + C + c], bytes[1 + C + c], &full[s]);
          }
        }
      } else if (vec) {
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
        for (int g = 0; g < gx; ++g)
          copy_padded(reinterpret_cast<uint16_t*>(st + g * L.slab), src + (size_t)g * Y * ZT, Y,
                      Z, ZT, L.ZS, lane);
        for (int c = 0; c < C; ++c)
          copy_padded(t + c * L.G * L.ZS, txz + ((size_t)c * X + x0) * ZT, gx, Z, ZT, L.ZS, lane);
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
  if (kLong) {  // a warp a row, its lanes along z
    for (int r = warp; r < C * Y; r += W)
#pragma unroll 4
      for (int z = lane; z < L.ZS; z += 32)
        tyz_s[r * L.ZS + z] = z < Z ? tyz[(size_t)r * ZT + z] : 0.f;
  } else if (!vec) {
    for (int i = tid; i < C * Y * L.ZS; i += kConsumers) {
      const int z = i % L.ZS;
      tyz_s[i] = z < Z ? tyz[(size_t)(i / L.ZS) * ZT + z] : 0.f;
    }
  }
  if (!kLong)  // the long-row instance's txy travels with the slabs
    for (int i = tid; i < C * X * Y; i += kConsumers) txy_s[i] = txy[i];
  for (int i = tid; i < C * Y; i += kConsumers) m1_s[i] = 0.f;
  consumers_sync(kConsumers);
  if (vec && !kLong) mbar_wait(tmpl, 0);

  float2 acc3[C][KM];  // m3 partials of this lane's pairs over the warp's rows
  float p1[R][C];      // m1 partials of the warp's first R rows
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < KM; ++k) acc3[c][k] = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) p1[r][c] = 0.f;
  }

  for (int u = 0; u < U; ++u) {
    const int s = u % L.NS, b = unit_scan(u), x0 = unit_x0(u), gx = unit_gx(u);
    mbar_wait(&full[s], (u / L.NS) & 1);  // unit u has landed
    uint32_t* st = ring + s * L.stage;
    // Long rows: where the unit's slabs and each class's txz and txy runs
    // begin in their stage regions (bf16 values, floats).
    int e0 = 0, o1[C], o3[C];
    if (kLong) {
      e0 = lead(cube + ((size_t)b * X + x0) * Y * ZT, 2);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        o1[c] = lead(txz + ((size_t)c * X + x0) * Z, 4);
        o3[c] = lead(txy + ((size_t)c * X + x0) * Y, 4);
      }
    }
    for (int g = 0; g < gx; ++g) {
      const int x = x0 + g;
      if constexpr (kLong) {
        const float* tz = reinterpret_cast<const float*>(st + L.txz);
        const float* ty = reinterpret_cast<const float*>(st + L.sxy);
        float2 a[C][KM];  // txz[c, x, this lane's pairs], zero past Z
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            const float* row = tz + c * L.zw + o1[c] + g * Z;
            const int z = 2 * (lane + 32 * k);
            a[c][k] = make_float2(k < L.KP && z < Z ? row[z] : 0.f,
                                  k < L.KP && z + 1 < Z ? row[z + 1] : 0.f);
          }
        float q[C];
#pragma unroll
        for (int c = 0; c < C; ++c) q[c] = 0.f;
        auto t3_of = [&](int y, float (&t3)[C]) {
#pragma unroll
          for (int c = 0; c < C; ++c) t3[c] = ty[c * L.yw + o3[c] + g * Y + y];
        };
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int y = warp + r * W;
          if (y < Y) {
            float t3[C];
            t3_of(y, t3);
            row_step_long<C>(st, e0 + (g * Y + y) * Z, tyz_s + y * L.ZS, Y * L.ZS, t3, a, p1[r],
                             q, acc3, lane, L.KP, L.ZP, Z);
          }
        }
        for (int y = warp + R * W; y < Y; y += W) {  // rows past the registers (Y > 32)
          float t3[C], p[C];
          t3_of(y, t3);
#pragma unroll
          for (int c = 0; c < C; ++c) p[c] = 0.f;
          row_step_long<C>(st, e0 + (g * Y + y) * Z, tyz_s + y * L.ZS, Y * L.ZS, t3, a, p, q,
                           acc3, lane, L.KP, L.ZP, Z);
#pragma unroll
          for (int c = 0; c < C; ++c) p[c] = warp_sum(p[c]);
          if (lane == 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) m1_s[c * Y + y] += p[c];
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) q[c] = warp_sum(q[c]);
        if (lane == 0) {
          float* p2 = reinterpret_cast<float*>(st + L.p2);
#pragma unroll
          for (int c = 0; c < C; ++c) p2[(g * W + warp) * C + c] = q[c];
        }
        continue;
      }
      const uint32_t* slab = st + g * L.slab;
      const float* txz_s = reinterpret_cast<const float*>(st + L.txz) + g * L.ZS;

      float2 a[C][KM];  // txz[c, x, this lane's pairs]
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < KM; ++k) {
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
        if (lane == 0 && y < Y) {
          float* out = m1 + ((size_t)b * CT + c) * Y + y;
          *out = accum ? *out + v : v;
        }
      }
    }
    if (lane == 0)
      for (int y = warp + R * W; y < Y; y += W)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float* out = m1 + ((size_t)b * CT + c) * Y + y;
          *out = accum ? *out + m1_s[c * Y + y] : m1_s[c * Y + y];
          m1_s[c * Y + y] = 0.f;
        }
    // m3: the warps add their partials to the running sum in turn, warp 0
    // first; the last one stores the result and hands the turn back to
    // warp 0 for the next scan. A warp waits only for the one before it.
    mbar_wait(&turn[warp], (u / NG) & 1);
    float2 run[C][KM];  // all loads first, so that they are in flight together
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        const int pair = lane + 32 * k;
        run[c][k] = (warp > 0 && k < L.KP && pair < L.ZP)
                        ? *reinterpret_cast<const float2*>(m3_s + c * L.ZS + 2 * pair)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        const int pair = lane + 32 * k;
        if (k < L.KP && pair < L.ZP) {
          float2 v = acc3[c][k];
          if (warp > 0) v = make_float2(run[c][k].x + v.x, run[c][k].y + v.y);
          if (warp < W - 1) {
            *reinterpret_cast<float2*>(m3_s + c * L.ZS + 2 * pair) = v;
          } else {
            float* out = m3 + ((size_t)b * CT + c) * ZT + 2 * pair;
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

template <int C, bool kLong = false>
int launch(const void* cube, const void* txz, const void* tyz, const void* txy, void* m1,
           void* m2, void* m3, int B, int X, int Y, int Z, int ZT, int CT, int accum,
           cudaStream_t stream) {
  constexpr int kThreads = 32 * ((kLong ? kLongWarps : warps_for(C)) + 1);
  const Layout L = make_layout(X, Y, Z, C, kLong);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  const int vec = kLong || (Z == ZT && Z % 8 == 0 && ((uintptr_t)cube & 15) == 0 &&
                            ((uintptr_t)txz & 15) == 0 && ((uintptr_t)tyz & 15) == 0);
  cudaError_t err = cudaFuncSetAttribute(native_tables_kernel<C, kLong>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, native_tables_kernel<C, kLong>, kThreads, L.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < nsm * per_sm ? B : nsm * per_sm;
  native_tables_kernel<C, kLong><<<grid, kThreads, L.total, stream>>>(
      static_cast<const uint16_t*>(cube), static_cast<const float*>(txz),
      static_cast<const float*>(tyz), static_cast<const float*>(txy), static_cast<float*>(m1),
      static_cast<float*>(m2), static_cast<float*>(m3), B, X, Y, Z, vec, ZT, CT, accum);
  return (int)cudaGetLastError();
}

// A launch whose z-chunk is longer than a lane's pairs of the default
// instance hold runs the long-row instance.
__host__ __device__ inline bool long_rows(int zc) { return zc > 2 * 32 * kMaxPairs; }

// The work plan of C classes at arena Z: z-chunks of ZC values (the last
// one may be shorter) and class groups of CG classes (the last may have
// fewer). The fewest chunks that keep a lane's pairs in registers (ZC <=
// 2 * 32 * kMaxPairs), then the fewest groups of at most kMaxC classes
// whose block fits the shared-memory maximum, then more chunks (ZC a
// multiple of 8) until one class fits. Where Z needs more than one chunk
// but fits the long-row instance (Z <= 2 * 32 * kLongPairs), that
// instance's plan, one chunk of Z in the fewest groups of at most
// kLongMaxC classes whose block fits, takes the place of this one when it
// makes no more launches. False when not even 8 z of one class fit (the
// txy template alone, C * X * Y floats, is then near 227 KB).
// ops/score.py's native_plan mirrors it for the tests; the wrapper asks
// native_score_plan_zchunk before a launch.
struct Plan {
  int ZC, CG;
};
bool make_plan(int X, int Y, int Z, int C, Plan& p) {
  constexpr int kMaxZ = 2 * 32 * kMaxPairs;
  bool found = false;
  for (int nz = (Z + kMaxZ - 1) / kMaxZ; !found; ++nz) {
    const int zc = nz == 1 ? Z : ((Z + nz - 1) / nz + 7) / 8 * 8;
    for (int ng = (C + kMaxC - 1) / kMaxC; ng <= C && !found; ++ng) {
      const int cg = (C + ng - 1) / ng;
      if (make_layout(X, Y, zc, cg).total <= kSmemMax) {
        p.ZC = zc;
        p.CG = cg;
        found = true;
      }
    }
    if (!found && zc <= 8) return false;
  }
  if (long_rows(Z) && Z <= 2 * 32 * kLongPairs) {
    const int launches = (Z + p.ZC - 1) / p.ZC * ((C + p.CG - 1) / p.CG);
    for (int ng = (C + kLongMaxC - 1) / kLongMaxC; ng <= C && ng <= launches; ++ng) {
      const int cg = (C + ng - 1) / ng;
      if (make_layout(X, Y, Z, cg, true).total <= kSmemMax) {
        p.ZC = Z;
        p.CG = cg;
        break;
      }
    }
  }
  return true;
}

int launch_group(int cg, const void* cube, const void* txz, const void* tyz, const void* txy,
                 void* m1, void* m2, void* m3, int B, int X, int Y, int Z, int ZT, int CT,
                 int accum, cudaStream_t s) {
  if (long_rows(Z)) switch (cg) {
      case 1: return launch<1, true>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
      case 2: return launch<2, true>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
      default: return launch<3, true>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    }
  switch (cg) {
    case 1: return launch<1>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 2: return launch<2>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 3: return launch<3>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 4: return launch<4>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 5: return launch<5>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 6: return launch<6>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    case 7: return launch<7>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
    default: return launch<8>(cube, txz, tyz, txy, m1, m2, m3, B, X, Y, Z, ZT, CT, accum, s);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes at these dims with C classes
// a launch (exposed so the wrapper's own count can be checked against it).
long native_score_smem_bytes(int X, int Y, int Z, int C) {
  return make_layout(X, Y, Z, C, long_rows(Z)).total;
}

// The work plan of make_plan: its z-chunk and its class group, or 0 for
// shapes the kernel does not take (exposed so the wrapper's own plan can be
// checked against it).
int native_score_plan_zchunk(int X, int Y, int Z, int C) {
  Plan p;
  return X >= 1 && Y >= 1 && Z >= 1 && C >= 1 && make_plan(X, Y, Z, C, p) ? p.ZC : 0;
}
int native_score_plan_group(int X, int Y, int Z, int C) {
  Plan p;
  return X >= 1 && Y >= 1 && Z >= 1 && C >= 1 && make_plan(X, Y, Z, C, p) ? p.CG : 0;
}

// Launch the tables on `stream`: bf16 cube (B, X, Y, Z), float32 templates
// txz (C, X, Z), tyz (C, Y, Z), txy (C, X, Y), all contiguous; float32
// outputs m1 (B, C, Y), m2 (B, C, X), m3 (B, C, Z), every element written.
// One launch per (z-chunk, class group) of make_plan, the chunks in order
// (each after the first adds its m1 and m2 sums); at the default arena with
// up to 7 classes that is one launch. Returns cudaGetLastError() after the
// last launch (or the first error, or cudaErrorInvalidValue for shapes the
// kernel does not take); the launches do not synchronise.
int native_score_tables(const void* cube, const void* txz, const void* tyz, const void* txy,
                        void* m1, void* m2, void* m3, int B, int X, int Y, int Z, int C,
                        void* stream) {
  Plan p;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C < 1 || !make_plan(X, Y, Z, C, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* v = static_cast<const uint16_t*>(cube);
  const float *a = static_cast<const float*>(txz), *t = static_cast<const float*>(tyz),
              *u = static_cast<const float*>(txy);
  float *o1 = static_cast<float*>(m1), *o2 = static_cast<float*>(m2),
        *o3 = static_cast<float*>(m3);
  for (int z0 = 0; z0 < Z; z0 += p.ZC) {
    const int zc = min(p.ZC, Z - z0);
    for (int c0 = 0; c0 < C; c0 += p.CG) {
      const int cg = min(p.CG, C - c0);
      const int err = launch_group(
          cg, v + z0, a + (size_t)c0 * X * Z + z0, t + (size_t)c0 * Y * Z + z0,
          u + (size_t)c0 * X * Y, o1 + (size_t)c0 * Y, o2 + (size_t)c0 * X,
          o3 + (size_t)c0 * Z + z0, B, X, Y, zc, Z, C, z0 > 0, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // extern "C"
