// One-pass int8 contraction tables for the fused predict path (Hopper, sm_90a).
//
// Five kernels share one block routine, walk_scans, and differ in how a
// batch is cut and in what they write where a scan is complete:
//   combo_tables_kernel   <- radarml_tpu/ops/pallas_i8_score.py ::
//                            onepass_tables_combined_i8 (body _kernel_combined_zc),
//                            the "combo" tail: the three tables
//   lookup_tables_kernel  <- onepass_tables_i8 (body _kernel), the "lookup"
//                            tail: the same tables, a scan cut into parts
//                            across blocks when the batch is small
//   grouped_tables_kernel <- onepass_tables_grouped_i8 (body
//                            _kernel_grouped_tables), the "glookup" tail:
//                            the lookup kernel under its own symbol (the
//                            TPU kernel's y-groups are its tiling only)
//   sel_tables_kernel     <- onepass_tables_sel_i8 (body _kernel_sel), the
//                            "sel" tail: t1 and t2, and of t3 only the
//                            target reads
//   sel3_scores_kernel    <- onepass_scores_i8 (body _kernel_scores), the
//                            "sel3" tail: only the target reads leave the block
// For each scan b of an int8 cube batch v (B, X, Y, Z) holding value-128,
// and int8 class templates qxz (C2, X, Z), qyz (C2, Y, Z), qxy (C2, X, Y),
// the tables are
//
//   t1[b, c, y] = sum_{x,z} qxz[c, x, z] * v[b, x, y, z]
//   t2[b, c, x] = sum_{y,z} qyz[c, y, z] * v[b, x, y, z]
//   t3[b, z, c] = sum_{x,y} qxy[c, x, y] * v[b, x, y, z]
//
// exactly, in int32. A null template pointer is a masked plane: its table
// comes out zero and its work is skipped.
//
// What bounds them on an H100: the cube read. At the default arena a scan
// is 22*31*176 = 120,032 bytes against ~2.2M int8 MACs for the three
// tables, so at 3.35 TB/s a batch of 4096 scans needs ~0.15 ms of reads;
// the MACs are 9 us of the int8 tensor cores. The kernels these replaced
// took every dot product with __dp4a, and the dp4a rate set their pace:
// the combo kernel's 2.2e9 dp4a per 4096 scans in 0.80 ms are 12 lanes a
// clock per SM; the lookup, sel3, glookup and sel kernels (one block per
// tile of a scan, synchronous loads, templates re-read from L2 per tile)
// took 1.84, 1.15, 0.93 and 1.15 ms.
//
// What the design does about it: all three contractions run on the int8
// tensor cores as mma.sync m16n8k32 (s8 x s8 -> s32), the templates as the
// B operand (8 columns = at most 8 class rows, zeros past C2).
// - The work plan. A scan is cut into P parts of contiguous x-slabs (part
//   p takes slabs [p * nslab / P, (p + 1) * nslab / P), as
//   ops/i8_tails.part_slabs computes them); block i takes part i % P of
//   scans i / P, + G, + 2G, ... with G = gridDim.x / P, so a block keeps
//   one part for its life. The combo, sel and sel3 kernels take whole scans
//   (P = 1: one persistent block per SM walking scans b = blockIdx.x,
//   + gridDim.x, ...). The lookup and glookup kernels take P from the host
//   (ops/i8_tails.lookup_plan): 1 while the batch fills the resident
//   blocks; below that resident / B parts, rounded down or up, whichever
//   leaves the busiest block the fewest x rows, with a narrower slab where
//   that gives more slabs, so that a small batch keeps every SM busy.
//   Launches run min(B, resident / P) scans at a time, one block a part. A
//   part's block holds only its part's qxz rows and packed qxy words.
// - The templates are copied into shared memory once per block and stay
//   there: qxz and qyz one row per (x or y, class), zero-padded in z to
//   whole 32-byte chunks plus 16 bytes, so the eight class rows of a
//   fragment lie an odd number of 16-byte units apart (no bank
//   conflicts); qxy packed four rows to a word.
// - Slabs are double-buffered. Where rows are whole 16-byte units (Z % 16
//   == 0 and an aligned cube), one thread brings a slab (contiguous in
//   device memory) with a single cp.async.bulk that reports to an mbarrier,
//   two slabs ahead of the one computed; otherwise all threads copy it with
//   byte loads into rows padded to 16 bytes. The compute is the same.
// - t1 and t2 take cube rows as the A operand, K-major as they lie,
//   fragments by ldmatrix:
//     t1: A = 16 values of y at one x, B = qxz[., x, z-chunk]; D[y, c]
//         carries over z and x;
//     t2: A = 16 values of x at one y (rows Y * Z bytes apart), B =
//         qyz[., y, z-chunk]; D[x, c] carries over z and y.
//   A template chunk is read once per 16 cube rows. The (tile, row, half of
//   the z-chunks) steps of a slab form one list that the warps cut into
//   equal contiguous runs; a warp keeps its D in registers (three
//   accumulators in turn, so that consecutive mma do not wait for each
//   other) and adds it to the scan's tables in shared memory (int32
//   atomics, exact in any order) whenever its run crosses into another
//   tile. Tile rows past Y (or the slab's x rows) repeat the last valid row
//   and are dropped from D: nothing is read past the slab. At the default
//   arena rows 176 and 5,456 bytes apart both put the eight rows of an
//   ldmatrix on eight different 16-byte bank groups. wgmma fits badly: it
//   wants 64 rows that share a template, and here 31 or 22 do, with C2 <= 8
//   columns.
// - t3 contracts over x and y while z is the minor axis, so its A operand
//   (rows z, K over the slab's (x, y) rows) needs byte transposes whatever
//   computes it: a lane reads one z-word of four rows twice, transposes the
//   4 x 4 bytes with byte permutes, and the four z of a word become two rows
//   each of two 16-row tiles; the packed qxy words are the B fragments as
//   they lie. Steps (group of 32 z, chunk of 32 rows) are cut into runs like
//   t1's and t2's.
// - The scan's tables exist twice in shared memory and scans alternate, so
//   a finished scan's set is handed to the kernel's epilogue while the next
//   scan already sums into the other. The epilogues:
//     StoreTables (combo; lookup and glookup at P = 1): every output
//       element exactly once by plain stores, each cleared by the thread
//       that wrote it, with no block barrier of its own (the set is next
//       used two scans on);
//     AddPart (lookup and glookup at P > 1): a part owns its x, so it
//       stores its t2 rows; it adds its t1 and t3 partials by int32
//       atomicAdd, exact in any order, into outputs its C entry zeroes on
//       the stream first;
//     ReadScores (sel3): the T x C2 reads s1 = t1[c, j], s2 = t2[c, i],
//       s3 = t3[k, c] of each slot of the (B, T, 3) indices (zero for an
//       index outside its range, -1 included, and for a slot whose valid
//       byte is 0);
//     SelTables (sel): t1 and t2 stored as StoreTables stores them, and
//       d3 = t3[k, c] of each slot's z index, read as ReadScores reads.
//     In the last two, threads read elements that other threads clear, so
//       a block barrier must separate the two (ReadThenClear, shared by
//       both): the set is cleared ahead of the next scan's last slab, after
//       that scan's first slab barrier (a barrier in the epilogue, read /
//       wait / clear, cost 5%), or, with one slab a scan, read / wait /
//       clear.
// Where they stand (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py and
// radarml_tpu_torch/utils/kernel_probe.py; PERF.md section 6): the combo
// kernel 0.27 ms device at B=4096 against 0.800 for the dp4a kernel it
// replaced and a 0.154 ms bytes bound; 0.019 ms at B=64 against 0.0319.
// With the loads alone it takes 0.186 ms; a slab costs ~7,500 clocks, of
// which ~3,400 are a warp's t1 / t2 steps, ~2,300 its t3 steps, up to
// ~1,200 the wait for the slowest warp at the slab's barrier (t2's steps
// cost more than t1's, and equal runs are not equal times) and ~700 the
// write-out. 24 warps were slower (0.279 ms), and so was giving each warp
// a run of each kind (more, shorter runs). The lookup kernel takes the
// combo kernel's time at B=4096 and 0.013 ms at B=64 (two parts a scan;
// 0.016 with three), and the glookup kernel the lookup kernel's; the sel3
// kernel 0.274 and 0.019, the sel kernel 0.268 and 0.019 (0.296 and 0.019
// with a barrier in its epilogue).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC2 = 8;      // class rows (levels * classes) per table: one mma n-tile
constexpr int kThreads = 512;  // one block per SM
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;  // one block's dynamic maximum (227 KB)

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared-memory carve-up of one block, in 32-bit words (each region a
// multiple of 4 words, so 16-byte aligned), for scans cut into P parts of
// x-slabs XS wide: a block holds the templates of its part only. Host and
// device compute it the same way.
struct Layout {
  int XS, nslab, nsp, XP, NR, SW, ZW, nk, TW, KQ;
  int qxz, qyz, zero, qxy, cube, slab, m1, m2, m3, tabs;
  size_t total;  // bytes
};

__host__ __device__ inline Layout make_layout(int XS, int P, int X, int Y, int Z, int C2,
                                              bool h1, bool h2, bool h3) {
  Layout L;
  L.XS = XS;
  L.nslab = (X + XS - 1) / XS;
  L.nsp = (L.nslab + P - 1) / P;     // slabs of the largest part
  L.XP = min(X, L.nsp * XS);         // and its x rows
  L.NR = round_up(XS * Y, 4);        // rows per slab buffer, whole quads
  L.SW = round_up(Z, 16) / 4;        // cube row pitch in words (16-byte units)
  L.ZW = (Z + 3) / 4;                // 4-z words that hold data
  L.nk = (L.SW * 4 + 31) / 32;       // 32-byte z-chunks per row
  L.TW = L.nk * 8 + 4;               // template row pitch in words
  int off = 0;
  L.qxz = off;  off += h1 ? C2 * L.XP * L.TW : 0;
  L.qyz = off;  off += h2 ? C2 * Y * L.TW : 0;
  L.zero = off; off += L.TW;
  L.KQ = (XS * Y + 31) / 32 * 8;     // row quads of a slab, in whole 32-row chunks
  L.qxy = off;  off += h3 ? L.nsp * kMaxC2 * L.KQ : 0;
  // a buffer ends with 16 spare bytes: a row's last chunk may read that far
  L.slab = round_up(L.NR * L.SW + 4, 4);
  L.cube = off; off += 2 * L.slab;
  // the scan's tables, twice: scans alternate, so one set is written out
  // and cleared while the next scan already sums into the other
  L.m1 = off;
  L.m2 = L.m1 + round_up(C2 * Y, 4);
  L.m3 = L.m2 + round_up(C2 * X, 4);
  L.tabs = L.m3 + round_up(Z * C2, 4) - L.m1;
  off += 2 * L.tabs;
  L.total = (size_t)off * 4;
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

// Four 8 x 16-byte matrices: lane l gives the address of row l % 8 of matrix
// l / 8 and receives bytes 4 * (l % 4) .. + 3 of row l / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// d (16 x 8, int32) += a (16 rows x 32 int8, K-major) * b (8 columns x 32 int8, K-major)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy nrows rows of Z int8 values (row r at src + r * Z) into shared rows
// of SW words, zero-padding z up to SW * 4, with byte loads.
__device__ void copy_rows(int* dst, const int8_t* src, int nrows, int Z, int SW) {
  int8_t* d = reinterpret_cast<int8_t*>(dst);
  const int Zp = SW * 4;
  for (int i = threadIdx.x; i < nrows * Zp; i += blockDim.x) {
    const int r = i / Zp, z = i % Zp;
    d[i] = z < Z ? src[(size_t)r * Z + z] : int8_t(0);
  }
}

// Rows r0 .. r0 + n - 1 of a plane's templates (C2, R, Z) into rows [r][c]
// of TW words, z zero-padded: 16 bytes at a time where rows are whole
// aligned 16-byte units, by bytes otherwise.
__device__ void copy_templates(int* dst, const int8_t* src, int C2, int R, int r0, int n,
                               int Z, int TW) {
  if (Z % 16 == 0 && ((uintptr_t)src & 15) == 0) {
    const int4* s16 = reinterpret_cast<const int4*>(src);
    int4* d16 = reinterpret_cast<int4*>(dst);
    const int ZV = Z / 16, TV = TW / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * C2 * TV; i += blockDim.x) {
      const int v = i % TV, c = (i / TV) % C2, r = i / (TV * C2);
      d16[i] = v < ZV ? __ldg(s16 + ((size_t)c * R + r0 + r) * ZV + v) : make_int4(0, 0, 0, 0);
    }
    return;
  }
  int8_t* d = reinterpret_cast<int8_t*>(dst);
  const int Tp = TW * 4;
  for (int i = threadIdx.x; i < n * C2 * Tp; i += blockDim.x) {
    const int z = i % Tp, c = (i / Tp) % C2, r = i / (Tp * C2);
    d[i] = z < Z ? src[((size_t)c * R + r0 + r) * Z + z] : int8_t(0);
  }
}

// What every kernel's walk is given: the cube, the templates, the x-slab
// width XS and the parts P a scan is cut into; vec: slabs by bulk copy.
struct Walk {
  const int8_t* cube;
  const int8_t* qxz;
  const int8_t* qyz;
  const int8_t* qxy;
  int B, X, Y, Z, C2, XS, P, vec;
};

// The block routine of the three kernels: sums its part of each of its
// scans into a table set in shared memory and, where the part is complete,
// calls done(w, b, m1_s, m2_s, m3_s, xlo, xhi) with every thread of the
// block: scan b's sums m1_s[c * Y + y], m2_s[c * X + x], m3_s[z * C2 + c]
// over x in [xlo, xhi). `done` hands the set back cleared, or clears it
// later: before the part's last slab every thread calls
// done.ahead(other, words, ns) with the other set (`words` words, the
// previous scan's) and the part's slab count; where ns > 1 a block barrier
// of this scan has passed by then, so every thread is done with the other
// set, and the scan after this one is the next to use it.
template <class Done>
__device__ __forceinline__ void walk_scans(const Walk& w, Done& done) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) uint64_t full_bar[2];
  const int8_t* __restrict__ cube = w.cube;
  const int8_t* __restrict__ qxz = w.qxz;
  const int8_t* __restrict__ qyz = w.qyz;
  const int8_t* __restrict__ qxy = w.qxy;
  const int B = w.B, X = w.X, Y = w.Y, Z = w.Z, C2 = w.C2, XS = w.XS, vec = w.vec;
  const bool h1 = qxz != nullptr, h2 = qyz != nullptr, h3 = qxy != nullptr;
  const Layout L = make_layout(XS, w.P, X, Y, Z, C2, h1, h2, h3);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int* qxy_s = smem + L.qxy;  // [slab of the part][8 classes][KQ] words: 4 rows' bytes each, zeros past C2 and the slab

  // This block's part: slabs [s0, s1), x rows [xlo, xhi), of scans b0, b0 +
  // G, ...; its work units are (scan, slab of the part).
  const int P = w.P, G = gridDim.x / P, part = blockIdx.x % P, b0 = blockIdx.x / P;
  const int s0 = part * L.nslab / P, s1 = (part + 1) * L.nslab / P, ns = s1 - s0;
  const int xlo = s0 * XS, xhi = min(X, s1 * XS);
  const int nscan = (B - b0 + G - 1) / G;
  const int U = nscan * ns;
  // Unit u goes to buffer u % 2. With whole 16-byte rows thread 0 asks for
  // it in one bulk copy that reports to full_bar[u % 2]; otherwise every
  // thread copies bytes and the block's next barrier publishes them.
  auto load_unit = [&](int u) {
    if (vec && tid != 0) return;
    const int b = b0 + (u / ns) * G;
    const int x0 = (s0 + u % ns) * XS;
    const int xs = min(XS, X - x0);
    int* buf = smem + L.cube + (u & 1) * L.slab;
    const int8_t* src = cube + ((size_t)b * X + x0) * Y * Z;
    if (vec) {
      {
        // the buffer's readers are past the block barrier; order their reads
        // before the copy engine's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t bytes = (uint32_t)(xs * Y * Z);
        mbar_expect_tx(&full_bar[u & 1], bytes);
        bulk_copy(buf, src, bytes, &full_bar[u & 1]);
      }
    } else {
      copy_rows(buf, src, xs * Y, Z, L.SW);
    }
  };

  if (tid == 0) {
    mbar_init(&full_bar[0], 1);
    mbar_init(&full_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (U > 0) load_unit(0);
  if (U > 1) load_unit(1);
  // The part's templates, once per block (plain loads, overlapping the
  // first units).
  if (h1) copy_templates(smem + L.qxz, qxz, C2, X, xlo, xhi - xlo, Z, L.TW);
  if (h2) copy_templates(smem + L.qyz, qyz, C2, Y, 0, Y, Z, L.TW);
  if (h3) {
    int8_t* d = reinterpret_cast<int8_t*>(qxy_s);
    const int KR = L.KQ * 4;  // rows a class row of a slab holds
    for (int i = tid; i < ns * kMaxC2 * KR; i += blockDim.x) {
      const int r = i % KR, c = (i / KR) % kMaxC2, sl = i / (KR * kMaxC2);
      const int x0 = (s0 + sl) * XS, nr = min(XS, X - x0) * Y;
      d[i] = (c < C2 && r < nr) ? qxy[((size_t)c * X + x0) * Y + r] : int8_t(0);
    }
  }
  for (int i = tid; i < L.TW; i += blockDim.x) smem[L.zero + i] = 0;
  for (int i = tid; i < 2 * L.tabs; i += blockDim.x) smem[L.m1 + i] = 0;
  __syncthreads();

  const int pitch = L.SW * 4, tpitch = L.TW * 4;  // row pitches in bytes
  const int nyt = (Y + 15) / 16;                  // t1's 16-row tiles of y
  // ldmatrix roles of this lane. A (x4): tile row and 16-byte half of the
  // chunk; B (x2, lanes 0..15 give addresses): class row and half.
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_half = lane >> 4;
  const int b_c = lane & 7, b_half = (lane >> 3) & 1;
  const int g = lane / 4, t = lane % 4;           // D: rows g, g + 8; columns 2t, 2t + 1
  const uint32_t qxz_a = smem_u32(smem + L.qxz), qyz_a = smem_u32(smem + L.qyz);
  const uint32_t zero_a = smem_u32(smem + L.zero) + 16 * b_half;

  // Each warp's share of a slab's steps depends only on the slab's width, so
  // it is worked out once for full slabs and once for the scan's last one.
  // t1 / t2 steps are (tile, row, half of the z-chunks), halves fastest:
  // first t1's (tile of 16 y, x of the slab), then t2's (tile of 16 x of the
  // slab, y). t3 steps are (group of 32 z, chunk of 32 rows), chunks fastest.
  struct Run {
    int n, tab, tile, row, half;  // t1 / t2: steps, and where the first one is
    int n3, zg, kc, nkc;          // t3
  };
  auto make_run = [&](int xs) {
    Run r;
    const int nxt = (xs + 15) / 16;
    const int n1 = h1 ? nyt * xs * 2 : 0, n2 = h2 ? nxt * Y * 2 : 0;
    const int lo = (n1 + n2) * warp / kWarps;
    r.n = (n1 + n2) * (warp + 1) / kWarps - lo;
    if (lo < n1) {
      r.tab = 1; r.tile = lo / (xs * 2); r.row = lo % (xs * 2) / 2; r.half = lo & 1;
    } else {
      const int l2 = lo - n1;
      r.tab = 2; r.tile = l2 / (Y * 2); r.row = l2 % (Y * 2) / 2; r.half = l2 & 1;
    }
    r.nkc = (xs * Y + 31) / 32;
    const int n3 = h3 ? (L.ZW + 7) / 8 * r.nkc : 0, lo3 = n3 * warp / kWarps;
    r.n3 = n3 * (warp + 1) / kWarps - lo3;
    r.zg = lo3 / r.nkc; r.kc = lo3 % r.nkc;
    return r;
  };
  const int xs_last = X - (L.nslab - 1) * XS;
  const Run run_full = make_run(XS), run_last = make_run(xs_last);

  int b = b0, s = s0, set = 0;  // unit u is slab s of scan b; its table set
  for (int u = 0; u < U; ++u) {
    const bool last = s == L.nslab - 1;
    const int x0 = s * XS, xs = last ? xs_last : XS, nr = xs * Y;
    int* m1_s = smem + L.m1 + set * L.tabs;  // [c][Y], summed over the scan's slabs
    int* m2_s = m1_s + (L.m2 - L.m1);        // [c][X]
    int* m3_s = m1_s + (L.m3 - L.m1);        // [z][c]
    if (s == s1 - 1) done.ahead(smem + L.m1 + (set ^ 1) * L.tabs, L.tabs, ns);
    if (vec) mbar_wait(&full_bar[u & 1], (u >> 1) & 1);  // unit u has landed
    const int* buf = smem + L.cube + (u & 1) * L.slab;
    const uint32_t buf_a = smem_u32(buf) + 16 * a_half;

    // t1 / t2 on the tensor cores: this warp's run of steps.
    const int steps = last ? run_last.n : run_full.n;
    if (steps > 0) {
      const int nxt = (xs + 15) / 16;
      int tab = last ? run_last.tab : run_full.tab, tile = last ? run_last.tile : run_full.tile;
      int row = last ? run_last.row : run_full.row, half = last ? run_last.half : run_full.half;
      // Three accumulators take turns, so that consecutive mma do not wait
      // for each other; they are summed when a tile is left.
      int d[3][4] = {};
      // Add this warp's D to the scan's table and clear it: element i is
      // tile row g + 8 * (i / 2), class 2 * t + i % 2.
      auto flush = [&]() {
        int* dst = tab == 1 ? m1_s : m2_s + x0;
        const int stride = tab == 1 ? Y : X, rows = tab == 1 ? Y : xs;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * tile + g + 8 * (i >> 1), c = 2 * t + (i & 1);
          if (c < C2 && r < rows) atomicAdd(&dst[c * stride + r], d[0][i] + d[1][i] + d[2][i]);
          d[0][i] = d[1][i] = d[2][i] = 0;
        }
      };
      for (int it = 0; it < steps; ++it) {
        // cube row of this lane's tile row (rows past the edge repeat the last)
        int cr, trow;
        uint32_t tq;
        if (tab == 1) {
          cr = row * Y + min(16 * tile + a_row, Y - 1);
          trow = x0 - xlo + row; tq = qxz_a;
        } else {
          cr = min(16 * tile + a_row, xs - 1) * Y + row;
          trow = row; tq = qyz_a;
        }
        const int zc0 = half ? L.nk / 2 : 0, zc1 = half ? L.nk : L.nk / 2;
        uint32_t a_addr = buf_a + cr * pitch + zc0 * 32;
        uint32_t b_addr = (b_c < C2 ? tq + (trow * C2 + b_c) * tpitch + 16 * b_half : zero_a) +
                          zc0 * 32;
        for (int zc = zc0; zc < zc1; zc += 3, a_addr += 96, b_addr += 96) {
          uint32_t a[3][4], bq[3][2];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (zc + j < zc1) {  // all fragments first, then the products
              ldmatrix_x4(a[j], a_addr + 32 * j);
              ldmatrix_x2(bq[j], b_addr + 32 * j);
            }
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (zc + j < zc1) mma_s8(d[j], a[j], bq[j]);
        }
        if (++half == 2) {
          half = 0;
          if (++row == (tab == 1 ? xs : Y)) {  // the tile is complete
            flush();
            row = 0;
            if (++tile == (tab == 1 ? nyt : nxt)) { tab = 2; tile = 0; }
          }
        }
      }
      flush();  // a tile this warp leaves unfinished (zeros otherwise)
    }
    // t3 on the tensor cores: D[z, c] = sum over the slab's rows r = (x, y)
    // of v[r, z] * qxy[c, r], so K runs over rows while z is the minor axis
    // of the cube: the A fragment is built by 4 x 4 byte transposes. In a
    // step lane (g, t) reads the z-word 8 * group + g of rows 4 * t .. + 3
    // and 16 + 4 * t .. + 3 of the chunk, and the four z of a transposed
    // word become row g and g + 8 of two 16-row tiles (z = 4 * g + 0, 1 in
    // the first, + 2, 3 in the second). The warp adds its D to the scan's
    // table when it leaves a group.
    const int steps3 = last ? run_last.n3 : run_full.n3;
    if (steps3 > 0) {
      const int nkc = last ? run_last.nkc : run_full.nkc;
      int zg = last ? run_last.zg : run_full.zg, kc = last ? run_last.kc : run_full.kc;
      const int* qw = qxy_s + ((s - s0) * kMaxC2 + g) * L.KQ + t;
      int da[4] = {0, 0, 0, 0}, db[4] = {0, 0, 0, 0};
      auto flush3 = [&]() {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int z = 32 * zg + 4 * g + (i >> 1), c = 2 * t + (i & 1);
          if (c < C2) {
            if (z < Z) atomicAdd(&m3_s[z * C2 + c], da[i]);
            if (z + 2 < Z) atomicAdd(&m3_s[(z + 2) * C2 + c], db[i]);
          }
          da[i] = db[i] = 0;
        }
      };
      for (int it = 0; it < steps3; ++it) {
        const int* col = buf + min(8 * zg + g, L.SW - 1);
        uint32_t fa[4], fb[4], bq[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = 32 * kc + 16 * h + 4 * t;  // rows past the slab meet zero templates
          const int w0 = col[min(r0, nr - 1) * L.SW], w1 = col[min(r0 + 1, nr - 1) * L.SW];
          const int w2 = col[min(r0 + 2, nr - 1) * L.SW], w3 = col[min(r0 + 3, nr - 1) * L.SW];
          // 4x4 byte transpose: byte j of word i is row r0 + j at z = 4 * word + i
          const int lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
          const int hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
          fa[2 * h] = __byte_perm(lo01, lo23, 0x5410);
          fa[2 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
          fb[2 * h] = __byte_perm(hi01, hi23, 0x5410);
          fb[2 * h + 1] = __byte_perm(hi01, hi23, 0x7632);
        }
        bq[0] = qw[8 * kc];
        bq[1] = qw[8 * kc + 4];
        mma_s8(da, fa, bq);
        mma_s8(db, fb, bq);
        if (++kc == nkc) {
          flush3();
          kc = 0;
          ++zg;
        }
      }
      flush3();  // a group this warp leaves unfinished (zeros otherwise)
    }
    __syncthreads();  // the slab's sums are complete; its buffer is free

    if (u + 2 < U) load_unit(u + 2);
    if (++s == s1) {  // the scan's part is complete: hand its set over
      done(w, b, m1_s, m2_s, m3_s, xlo, xhi);
      s = s0;
      b += G;
      set ^= 1;  // this set is next used two scans on, block barriers later
    }
  }
}

// Whole scans: every output element exactly once, by plain stores; each
// element is cleared by the thread that wrote it out, so no barrier.
struct StoreTables {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void ahead(int*, int, int) {}
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int, int) const {
    const int n1 = w.C2 * w.Y, n2 = w.C2 * w.X, n3 = w.Z * w.C2;
    for (int i = threadIdx.x; i < max(n3, max(n1, n2)); i += blockDim.x) {
      if (i < n1) { t1[(size_t)b * n1 + i] = m1_s[i]; m1_s[i] = 0; }
      if (i < n2) { t2[(size_t)b * n2 + i] = m2_s[i]; m2_s[i] = 0; }
      if (i < n3) { t3[(size_t)b * n3 + i] = m3_s[i]; m3_s[i] = 0; }
    }
  }
};

// A part of a scan: its own t2 rows (x in [xlo, xhi)) by plain stores, its
// t1 and t3 partials added into zeroed outputs (int32 atomics, exact in any
// order; a zero partial is skipped).
struct AddPart {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int xlo, int xhi) const {
    const int n1 = w.C2 * w.Y, n2 = w.C2 * w.X, n3 = w.Z * w.C2;
    for (int i = threadIdx.x; i < max(n3, max(n1, n2)); i += blockDim.x) {
      if (i < n1) {
        if (m1_s[i]) atomicAdd(&t1[(size_t)b * n1 + i], m1_s[i]);
        m1_s[i] = 0;
      }
      if (i < n2) {
        const int x = i % w.X;
        if (x >= xlo && x < xhi) t2[(size_t)b * n2 + i] = m2_s[i];
        m2_s[i] = 0;
      }
      if (i < n3) {
        if (m3_s[i]) atomicAdd(&t3[(size_t)b * n3 + i], m3_s[i]);
        m3_s[i] = 0;
      }
    }
  }
};

// The lookup kernel's epilogue: whole scans as the combo kernel's, parts
// otherwise (one walk either way).
struct LookupTables {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void ahead(int*, int, int) {}
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int xlo, int xhi) {
    if (w.P == 1)
      StoreTables{t1, t2, t3}(w, b, m1_s, m2_s, m3_s, xlo, xhi);
    else
      AddPart{t1, t2, t3}(w, b, m1_s, m2_s, m3_s, xlo, xhi);
  }
};

// Epilogues whose threads read table elements that other threads clear
// (sel, sel3): every read must precede a block barrier that precedes the
// clearing. With more than one slab a scan, the set is cleared ahead of the
// next scan's last slab (after that scan's first slab barrier; the scan
// after it is the next to use the set); with one, the epilogue reads, waits
// at a block barrier and clears. `reads` does the reads (and any stores).
template <class Reads>
struct ReadThenClear {
  Reads reads;
  bool cleared_ahead;  // more than one slab a scan

  __device__ __forceinline__ void ahead(int* other, int words, int ns) {
    cleared_ahead = ns > 1;
    if (cleared_ahead)  // the previous scan's reads are behind this scan's first barrier
      for (int i = threadIdx.x; i < words; i += blockDim.x) other[i] = 0;
  }
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int, int) const {
    reads(w, b, m1_s, m2_s, m3_s);
    if (cleared_ahead) return;
    __syncthreads();  // every read of the set precedes its clearing
    const int n1 = w.C2 * w.Y, n2 = w.C2 * w.X, n3 = w.Z * w.C2;
    for (int i = threadIdx.x; i < max(n3, max(n1, n2)); i += blockDim.x) {
      if (i < n1) m1_s[i] = 0;
      if (i < n2) m2_s[i] = 0;
      if (i < n3) m3_s[i] = 0;
    }
  }
};

// sel3: the T x C2 target reads of scan b, s1 = t1[c, j], s2 = t2[c, i],
// s3 = t3[k, c] for the slot's (i, j, k), each zero for an index outside
// its range (-1 included) and for a slot whose valid byte is 0.
struct ReadScores {
  const int* ijk;
  const uint8_t* valid;  // (B, T) bytes, or null: every slot valid
  int T;
  int* s1;
  int* s2;
  int* s3;

  __device__ __forceinline__ void operator()(const Walk& w, int b, const int* m1_s,
                                             const int* m2_s, const int* m3_s) const {
    const int C2 = w.C2, X = w.X, Y = w.Y, Z = w.Z;
    for (int i = threadIdx.x; i < T * C2; i += blockDim.x) {
      const int t = i / C2, c = i % C2;
      const size_t slot = (size_t)b * T + t;
      const bool ok = valid == nullptr || valid[slot] != 0;
      const int x = ijk[slot * 3], y = ijk[slot * 3 + 1], z = ijk[slot * 3 + 2];
      const size_t o = slot * C2 + c;
      s1[o] = ok && y >= 0 && y < Y ? m1_s[c * Y + y] : 0;
      s2[o] = ok && x >= 0 && x < X ? m2_s[c * X + x] : 0;
      s3[o] = ok && z >= 0 && z < Z ? m3_s[z * C2 + c] : 0;
    }
  }
};

// sel: scan b's t1 and t2 stored whole, as StoreTables stores them, and of
// t3 only the T x C2 reads d3 = t3[k, c] of each slot's z index k (zero
// outside [0, Z), -1 included).
struct SelTables {
  const int* kidx;
  int T;
  int* t1;
  int* t2;
  int* d3;

  __device__ __forceinline__ void operator()(const Walk& w, int b, const int* m1_s,
                                             const int* m2_s, const int* m3_s) const {
    const int C2 = w.C2, Z = w.Z, n1 = C2 * w.Y, n2 = C2 * w.X;
    for (int i = threadIdx.x; i < max(n1, n2); i += blockDim.x) {
      if (i < n1) t1[(size_t)b * n1 + i] = m1_s[i];
      if (i < n2) t2[(size_t)b * n2 + i] = m2_s[i];
    }
    for (int i = threadIdx.x; i < T * C2; i += blockDim.x) {
      const int k = kidx[(size_t)b * T + i / C2];
      d3[(size_t)b * T * C2 + i] = k >= 0 && k < Z ? m3_s[k * C2 + i % C2] : 0;
    }
  }
};

// Outputs are scan-major int32 t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2).
__global__ void __launch_bounds__(kThreads, 1)
combo_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  StoreTables done{t1, t2, t3};
  walk_scans(w, done);
}

__global__ void __launch_bounds__(kThreads, 1)
lookup_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  LookupTables done{t1, t2, t3};
  walk_scans(w, done);
}

// The lookup kernel's plan and epilogue under a symbol of its own. The
// y-group of its weights is the TPU kernel's tiling and changes nothing
// here.
__global__ void __launch_bounds__(kThreads, 1)
grouped_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  LookupTables done{t1, t2, t3};
  walk_scans(w, done);
}

// Outputs t1 (B, C2, Y), t2 (B, C2, X) and d3 (B, T, C2); kidx (B, T) int32.
__global__ void __launch_bounds__(kThreads, 1)
sel_tables_kernel(Walk w, const int* __restrict__ kidx, int T, int* __restrict__ t1,
                  int* __restrict__ t2, int* __restrict__ d3) {
  ReadThenClear<SelTables> done{{kidx, T, t1, t2, d3}};
  walk_scans(w, done);
}

// Outputs s1, s2, s3 (B, T, C2); ijk (B, T, 3) int32.
__global__ void __launch_bounds__(kThreads, 1)
sel3_scores_kernel(Walk w, const int* __restrict__ ijk, const uint8_t* __restrict__ valid, int T,
                   int* __restrict__ s1, int* __restrict__ s2, int* __restrict__ s3) {
  ReadThenClear<ReadScores> done{{ijk, valid, T, s1, s2, s3}};
  walk_scans(w, done);
}

// The x-slab width of whole scans: the widest, balanced over the slabs,
// whose block fits the shared-memory maximum; 0 if no slab fits.
int slab_width(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  for (int XS = X; XS >= 1; --XS) {
    if (make_layout(XS, 1, X, Y, Z, C2, h1, h2, h3).total <= kSmemMax) {
      const int nslab = (X + XS - 1) / XS;
      return (X + nslab - 1) / nslab;
    }
  }
  return 0;
}

// Fill `w` for a launch with x-slabs XS wide and P parts a scan; false for
// shapes the kernels do not take.
bool make_walk(Walk& w, const void* cube, const void* qxz, const void* qyz, const void* qxy,
               int B, int X, int Y, int Z, int C2, int XS, int P) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C2 < 1 || C2 > kMaxC2 || XS < 1 || XS > X || P < 1 ||
      P > (X + XS - 1) / XS)
    return false;
  if (make_layout(XS, P, X, Y, Z, C2, qxz, qyz, qxy).total > kSmemMax) return false;
  w.cube = static_cast<const int8_t*>(cube);
  w.qxz = static_cast<const int8_t*>(qxz);
  w.qyz = static_cast<const int8_t*>(qyz);
  w.qxy = static_cast<const int8_t*>(qxy);
  w.B = B; w.X = X; w.Y = Y; w.Z = Z; w.C2 = C2; w.XS = XS; w.P = P;
  // Bulk copies need whole 16-byte rows from a 16-byte aligned cube (a slab
  // then starts and ends on 16 bytes) and at most 2^20 - 1 bytes a barrier.
  w.vec = Z % 16 == 0 && ((uintptr_t)cube & 15) == 0 && (long long)XS * Y * Z < (1 << 20);
  return true;
}

// Blocks of `kernel` that fit on the card at once with `smem` bytes of
// dynamic shared memory each (after allowing that much); 0 with `err` set
// on a CUDA error.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, cudaError_t& err) {
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, nsm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? nsm * per_sm : 0;
}

// Launch `kernel` over `w` on `stream`: G = min(B, resident / P) scans at a
// time, one block a part, so every block stays resident and keeps one
// part. Returns cudaGetLastError(); the launch does not synchronise.
template <typename Kernel, typename... Ts>
int launch(Kernel kernel, const Walk& w, void* stream, Ts... outs) {
  const size_t smem =
      make_layout(w.XS, w.P, w.X, w.Y, w.Z, w.C2, w.qxz, w.qyz, w.qxy).total;
  cudaError_t err;
  const int resident = resident_blocks(kernel, smem, err);
  if (err != cudaSuccess) return (int)err;
  const int G = min(w.B, max(1, resident / w.P));
  kernel<<<G * w.P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(w, outs...);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` resident at once when it takes whole scans (the batch
// at and above which the work plan does not cut scans), or minus a CUDA
// error (cudaErrorInvalidValue for shapes it does not take).
template <typename Kernel>
int whole_scan_resident(Kernel kernel, int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  const int XS = slab_width(X, Y, Z, C2, h1, h2, h3);
  if (XS == 0 || C2 < 1 || C2 > kMaxC2) return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const int n = resident_blocks(kernel, make_layout(XS, 1, X, Y, Z, C2, h1, h2, h3).total, err);
  return err == cudaSuccess ? n : -(int)err;
}

// Launch a tables kernel that takes the work plan (XS, P) from the host.
// Every element is written: at P > 1 t1 and t3 are first zeroed on
// `stream`, and the parts add into them.
template <typename Kernel>
int split_tables(Kernel kernel, const void* cube, const void* qxz, const void* qyz,
                 const void* qxy, void* t1, void* t2, void* t3, int B, int X, int Y, int Z,
                 int C2, int XS, int P, void* stream) {
  Walk w;
  if (XS > slab_width(X, Y, Z, C2, qxz, qyz, qxy) ||
      !make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2, XS, P))
    return (int)cudaErrorInvalidValue;
  if (P > 1) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(t1, 0, sizeof(int) * B * C2 * Y, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(t3, 0, sizeof(int) * B * Z * C2, s);
    if (err != cudaSuccess) return (int)err;
  }
  return launch(kernel, w, stream, static_cast<int*>(t1), static_cast<int*>(t2),
                static_cast<int*>(t3));
}

}  // namespace

extern "C" {

// The x-slab width of whole scans (exposed so the wrapper can report it and
// plan the lookup and glookup kernels' parts).
int i8_score_slab_width(int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return slab_width(X, Y, Z, C2, h1, h2, h3);
}

// whole_scan_resident of the lookup and the glookup kernel.
int i8_score_lookup_resident(int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return whole_scan_resident(lookup_tables_kernel, X, Y, Z, C2, h1, h2, h3);
}
int i8_score_grouped_resident(int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return whole_scan_resident(grouped_tables_kernel, X, Y, Z, C2, h1, h2, h3);
}

// The combo kernel on `stream`: whole scans. Outputs are scan-major int32
// t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2), every element written.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for shapes the kernel does not take); the launch does not synchronise.
int i8_score_onepass_tables(const void* cube, const void* qxz, const void* qyz,
                            const void* qxy, void* t1, void* t2, void* t3, int B,
                            int X, int Y, int Z, int C2, void* stream) {
  Walk w;
  if (!make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2,
                 slab_width(X, Y, Z, C2, qxz, qyz, qxy), 1))
    return (int)cudaErrorInvalidValue;
  return launch(combo_tables_kernel, w, stream, static_cast<int*>(t1), static_cast<int*>(t2),
                static_cast<int*>(t3));
}

// The lookup and glookup kernels: the same tables, each scan cut into P
// parts of x-slabs XS wide (1 <= P <= the slab count; XS at most the
// whole-scan width).
int i8_score_lookup_tables(const void* cube, const void* qxz, const void* qyz,
                           const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                           int Y, int Z, int C2, int XS, int P, void* stream) {
  return split_tables(lookup_tables_kernel, cube, qxz, qyz, qxy, t1, t2, t3, B, X, Y, Z, C2, XS,
                      P, stream);
}
int i8_score_grouped_tables(const void* cube, const void* qxz, const void* qyz,
                            const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                            int Y, int Z, int C2, int XS, int P, void* stream) {
  return split_tables(grouped_tables_kernel, cube, qxz, qyz, qxy, t1, t2, t3, B, X, Y, Z, C2, XS,
                      P, stream);
}

// The sel kernel: whole scans; t1 (B, C2, Y) and t2 (B, C2, X) and the
// selected z-table reads d3 (B, T, C2) of the int32 kidx (B, T); every
// output element is written.
int i8_score_sel_tables(const void* cube, const void* qxz, const void* qyz, const void* qxy,
                        const void* kidx, void* t1, void* t2, void* d3, int B, int X, int Y,
                        int Z, int C2, int T, void* stream) {
  Walk w;
  if (T < 0 || !make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2,
                          slab_width(X, Y, Z, C2, qxz, qyz, qxy), 1))
    return (int)cudaErrorInvalidValue;
  return launch(sel_tables_kernel, w, stream, static_cast<const int*>(kidx), T,
                static_cast<int*>(t1), static_cast<int*>(t2), static_cast<int*>(d3));
}

// The sel3 kernel: whole scans; the three selected reads s1, s2, s3
// (B, T, C2) of the int32 ijk (B, T, 3); `valid` (B, T) bytes or null;
// every output element is written.
int i8_score_sel3_scores(const void* cube, const void* qxz, const void* qyz, const void* qxy,
                         const void* ijk, const void* valid, void* s1, void* s2, void* s3,
                         int B, int X, int Y, int Z, int C2, int T, void* stream) {
  Walk w;
  if (T < 0 || !make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2,
                          slab_width(X, Y, Z, C2, qxz, qyz, qxy), 1))
    return (int)cudaErrorInvalidValue;
  return launch(sel3_scores_kernel, w, stream, static_cast<const int*>(ijk),
                static_cast<const uint8_t*>(valid), T, static_cast<int*>(s1),
                static_cast<int*>(s2), static_cast<int*>(s3));
}

}  // extern "C"
