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
// the MACs are 9 us of the int8 tensor cores at their peak, and the padded
// mma tiles the kernels issue (900 a scan at 6 class rows) ~24 us at the
// 1,280 TOPS that mma.sync m16n8k32 reaches on an H100 (1.67 SM clocks an
// mma; utils/kernel_probe.py mma). The kernels these replaced
// took every dot product with __dp4a, and the dp4a rate set their pace:
// the combo kernel's 2.2e9 dp4a per 4096 scans in 0.80 ms are 12 lanes a
// clock per SM; the lookup, sel3, glookup and sel kernels (one block per
// tile of a scan, synchronous loads, templates re-read from L2 per tile)
// took 1.84, 1.15, 0.93 and 1.15 ms.
//
// What the design does about it: all three contractions run on the int8
// tensor cores as mma.sync m16n8k32 (s8 x s8 -> s32), the templates as the
// B operand (n-tiles of 8 columns: 8 class rows, zeros past them).
// - Class rows a block (batch_rows, which the wrappers ask before a
//   launch). Up to 8 (one n-tile), one block a scan part. Past 8, one block
//   of two n-tiles takes all of them (the kTiles = 2 instance: each A
//   fragment of 16 cube rows, and each transposed t3 fragment, feeds both
//   tiles' mma, so a slab's cube-side work is done once for every row)
//   where that block's whole-scan slabs stay at least kWideSlab = 8 x rows
//   wide (all its templates stay resident, so more rows mean narrower
//   slabs; at the default arena 9 and 10 rows, slabs 8 wide) and the batch
//   holds at least 5 scans an SM (one_block_pays: below that the groups'
//   cheaper first rounds win). Otherwise the rows are cut into NG class
//   groups of at most 8, the fewest whose whole-scan layout below fits a
//   block's shared memory (group_rows); each block takes one group and holds only its templates;
//   the NG blocks of a scan part are neighbours in the grid and read the
//   same slabs at about the same time, so the cube's bytes come from
//   device memory about once and from L2 for the other groups (three
//   groups' loads alone take 1.27x one's). Narrow slabs cost more than
//   the groups they save: t2's 16-row tiles of x hold as many useful rows
//   as a slab is wide, and every slab reads the templates again. At 18
//   rows (9 classes) two blocks of two n-tiles at slabs 8 wide took 0.94
//   ms a call at B=4096 where three class groups at 11 took 0.86, and one
//   block's work for 24 rows took 0.43 at slabs 11 wide but 1.14 at 3
//   (NVIDIA H100 80GB HBM3, 700.00 W; utils/kernel_probe.py i8:
//   two_blocks, tiles3, tiles3_narrow), while 18 rows' resident templates
//   leave no room for slabs even 1 wide; so 9 classes keep their three
//   groups. What is left refused: an arena where
//   one class row's whole-scan layout (x-slabs one row wide) does not fit,
//   about 3 * Y * Z + 8 * X * Y + (X + Y) * Z bytes over 227 KB (at X =
//   43, Z = 351: more than 144 y values).
// - The work plan. A scan is cut into P parts of contiguous x-slabs (part
//   p takes slabs [p * nslab / P, (p + 1) * nslab / P), as
//   ops/i8_tails.part_slabs computes them); block i takes class group i %
//   NG and part i / NG % P of scans i / (NG * P), + G, + 2G, ... with G =
//   gridDim.x / (NG * P), so a block keeps one group and part for its
//   life. The combo, sel and sel3 kernels take whole scans
//   (P = 1: one persistent block per SM walking scans b = blockIdx.x,
//   + gridDim.x, ...). The lookup and glookup kernels take P from the host
//   (ops/i8_tails.lookup_plan): 1 while the batch fills the resident
//   blocks; below that resident / B parts, rounded down or up, whichever
//   leaves the busiest block the fewest x rows, with a narrower slab where
//   that gives more slabs, so that a small batch keeps every SM busy.
//   Launches run min(B, resident / (NG * P)) scans at a time, one block a
//   (group, part). A part's block holds only its part's qxz rows and packed
//   qxy words.
// - The templates are copied into shared memory once per block and stay
//   there (but qxz on the staged route): qxz and qyz one row per (x or y,
//   class), zero-padded in z to
//   whole 32-byte chunks plus 16 bytes, so the eight class rows of a
//   fragment lie an odd number of 16-byte units apart (no bank
//   conflicts); qxy packed four rows to a word.
// - Slabs are double-buffered. Where rows are whole 16-byte units (Z % 16
//   == 0 and an aligned cube), one thread brings a slab (contiguous in
//   device memory) with a single cp.async.bulk that reports to an mbarrier,
//   two slabs ahead of the one computed. Where they are not (Z = 351 at
//   the finer scan arenas), the staged route (staged_route): thread 0 asks
//   the copy engine for the 16-byte aligned run of device memory around the
//   next slab, and around each of its x rows' qxz class rows, into one
//   staging area; when the current slab's steps are done every thread
//   realigns those runs, 16 bytes a lane (two aligned 16-byte loads and
//   funnel shifts), into the buffer's rows padded to 16 bytes and its
//   [x][c] qxz rows, and after a block barrier asks for the next slab's
//   runs, whose copy overlaps this slab's steps. qxz thus travels with the
//   slabs instead of staying (about 95 KB at 43 x 31 x 351 with 6 class
//   rows), so slabs are 5 x rows wide there, not 1, and t2's 16-row tiles
//   hold 5 useful rows.
//   Past the staged route's fit (its staging area costs a slab: at X = 43,
//   Z = 351 above about 120 y values), and for an unaligned cube of whole
//   units, all threads copy a slab with byte loads. The compute is the
//   same on every route.
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
// radarml_tpu_torch/utils/kernel_probe.py; PERF.md section 6): at 5
// classes (10 rows, one block of two n-tiles) the five kernels take
// 0.50-0.53 ms a call at B=4096 against 0.58 in two class groups (0.49
// against 0.58 at 9 rows); at 9 classes 0.84-0.87 in three groups;
// the combo
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
// with a barrier in its epilogue). At 43 x 31 x 351 with 6 class rows the
// staged route takes 2.20-2.23 ms at B=4096 (a 0.5846 ms bytes bound),
// against 9.45-9.54 ms for the byte-copy route with one-row slabs it
// replaces; the realignment takes ~4,500 clocks of a ~14,600-clock slab
// (utils/kernel_probe.py i8).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (radarml_tpu_torch/ops/_cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC2 = 8;      // class rows of one mma n-tile
constexpr int kMaxTiles = 2;   // n-tiles of a block's class rows (kMaxTiles * kMaxC2 rows)
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
  int sq, stage, stc, stq, sts;  // staged route: the buffer's qxz rows; the staging areas
  size_t total;  // bytes
};

// `staged`: the staged route (staged_route), where a slab and its qxz rows
// reach shared memory by bulk copies of the 16-byte aligned runs of device
// memory that hold them and are realigned there.
__host__ __device__ inline Layout make_layout(int XS, int P, int X, int Y, int Z, int C2,
                                              bool h1, bool h2, bool h3, bool staged = false,
                                              int tiles = 1) {
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
  L.qxz = off;  off += h1 && !staged ? C2 * L.XP * L.TW : 0;  // staged: travels with the slabs
  L.qyz = off;  off += h2 ? C2 * Y * L.TW : 0;
  L.zero = off; off += L.TW;
  L.KQ = (XS * Y + 31) / 32 * 8;     // row quads of a slab, in whole 32-row chunks
  L.qxy = off;  off += h3 ? L.nsp * tiles * kMaxC2 * L.KQ : 0;
  // a buffer ends with 16 spare bytes: a row's last chunk may read that far
  L.slab = round_up(L.NR * L.SW + 4, 4);
  // staged: one buffer, which also holds its slab's qxz rows [x][c], and
  // one staging area, holding a unit's runs as copied: the slab's (a run
  // starts up to 15 bytes early and ends up to 15 late; the realignment
  // reads up to 32 bytes past), then each class row's qxz run
  L.sq = L.slab;
  if (staged && h1) L.slab += XS * C2 * L.TW;
  L.stc = staged ? round_up((XS * Y * Z + 30) / 4 + 8, 4) : 0;
  L.stq = staged && h1 ? round_up((XS * Z + 30) / 4 + 8, 4) : 0;
  L.sts = L.stc + C2 * L.stq;
  L.cube = off; off += (staged ? 1 : 2) * L.slab;
  L.stage = off; off += L.sts;
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
// mbar_wait for the staged route: a wait of more than 10 s traps, so a
// fault there ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
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

// The n bytes (at most 4; 0 past a row's end) at byte p of the words w,
// in a word's low bytes, zero above: two aligned word loads and a funnel
// shift. Reads the word after p's only where the bytes reach into it.
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* w, int p, int n) {
  if (n <= 0) return 0u;
  const int k = p >> 2, sh = 8 * (p & 3);
  const uint32_t lo = w[k], hi = (p & 3) + min(n, 4) > 4 ? w[k + 1] : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, sh);
  return n >= 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// The 16 bytes at byte p of the 16-byte aligned shared-memory run at
// address w, the n < 16 past a row's end zero, stored at shared address
// dst: two aligned 16-byte loads, the five words from p's word offset on
// picked by selects (neighbouring lanes may be on other rows) and
// funnel-shifted by its byte offset.
__device__ __forceinline__ void move_chunk(uint32_t dst, uint32_t w, int p, int n) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if (n > 0) {
    const uint32_t a = w + (uint32_t)(p >> 4) * 16;
    uint32_t v[8];
    asm("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(a));
    asm("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v[4]), "=r"(v[5]), "=r"(v[6]), "=r"(v[7]) : "r"(a + 16));
    const int ws = (p >> 2) & 3;
    const uint32_t sh = 8 * (p & 3);
    uint32_t x[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      x[k] = ws == 0 ? v[k] : ws == 1 ? v[k + 1] : ws == 2 ? v[k + 2] : v[k + 3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = __funnelshift_r(x[k], x[k + 1], sh);
      const int keep = n - 4 * k;  // bytes of word k inside the row
      if (keep < 4) o[k] = keep <= 0 ? 0u : o[k] & ((1u << (8 * keep)) - 1u);
    }
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(dst), "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]));
}

// i / d for the small i of a block's work items, d = 1 or m = 2^32 / d
// rounded up (exact for i < 2^32 / d).
__device__ __forceinline__ int div_by(int i, int d, uint32_t m) {
  return d == 1 ? i : (int)__umulhi((uint32_t)i, m);
}
__host__ __device__ inline uint32_t div_magic(int d) {
  return d <= 1 ? 0u : 0xffffffffu / (uint32_t)d + 1u;
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
// of SW words, zero-padding z up to SW * 4, with byte loads. The general
// instance issues a thread's 8 loads of a round before any of its stores,
// so that they are in flight together; the other one, launched only on the
// bulk-copy route, never runs this and keeps the loop of the kernel before
// class groups.
template <bool kGeneral>
__device__ void copy_rows(int* dst, const int8_t* src, int nrows, int Z, int SW) {
  int8_t* d = reinterpret_cast<int8_t*>(dst);
  const int Zp = SW * 4;
  if (!kGeneral) {
    for (int i = threadIdx.x; i < nrows * Zp; i += blockDim.x) {
      const int r = i / Zp, z = i % Zp;
      d[i] = z < Z ? src[(size_t)r * Z + z] : int8_t(0);
    }
    return;
  }
  constexpr int kInFlight = 8;
  const int n = nrows * Zp, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInFlight * step) {
    int8_t v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = i0 + k * step, r = i / Zp, z = i % Zp;
      v[k] = i < n && z < Z ? src[(size_t)r * Z + z] : int8_t(0);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (i0 + k * step < n) d[i0 + k * step] = v[k];
  }
}

// Rows r0 .. r0 + n - 1 of a plane's templates (C2, R, Z) into rows [r][c]
// of TW words, z zero-padded: 16 bytes at a time where rows are whole
// aligned 16-byte units, by bytes otherwise.
template <bool kGeneral>
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
  if (kGeneral) {  // a word at a time: aligned word loads and a funnel shift
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>((uintptr_t)src & ~uintptr_t(3));
    const int lead = (int)((uintptr_t)src & 3);
    for (int i = threadIdx.x; i < n * C2 * TW; i += blockDim.x) {
      const int j = i % TW, c = (i / TW) % C2, r = i / (TW * C2);
      dst[i] = (int)bytes_at(s4, lead + (int)(((size_t)c * R + r0 + r) * Z) + 4 * j, Z - 4 * j);
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

// What every kernel's walk is given: the cube, the templates of all CT
// class rows, the rows of a class group C2 and the groups NG, the x-slab
// width XS and the parts P a scan is cut into; vec: slabs by bulk copy.
// The walk hands its epilogue a copy for the block's own group: C2 its
// rows, c0 its first row, the template pointers moved to that row.
struct Walk {
  const int8_t* cube;
  const int8_t* qxz;
  const int8_t* qyz;
  const int8_t* qxy;
  int B, X, Y, Z, C2, XS, P, vec, staged;
  int CT, NG, c0;
};

// Every epilogue is compiled twice and every kernel three times: kGeneral
// = false for one class group of one n-tile on the bulk-copy route (the
// host launches it whenever NG = 1 and vec, and it is the code of the
// kernel before class groups, the default arena's), true for the rest:
// several class groups, the other routes, and (kTiles = kMaxTiles) one
// block of several n-tiles.
//
// In the epilogues below the other instance's expressions are the ones of
// the kernel before class groups.
//
// Where element i = z * C2 + c of the block group's t3 set of scan b lies
// in the scan-major (B, Z, CT) output.
__device__ __forceinline__ size_t t3_at(const Walk& w, int b, int i) {
  return ((size_t)b * w.Z + i / w.C2) * w.CT + w.c0 + i % w.C2;
}

// Where scan b's rows of the block group start in a (B, CT, n) output
// (t1: n = Y, t2: n = X): the group's rows are contiguous in the scan's.
__device__ __forceinline__ size_t rows_at(const Walk& w, int b, int n) {
  return ((size_t)b * w.CT + w.c0) * n;
}

// The block routine of the three kernels: sums its part of each of its
// scans into a table set in shared memory and, where the part is complete,
// calls done(wg, b, m1_s, m2_s, m3_s, xlo, xhi) with every thread of the
// block: scan b's sums m1_s[c * Y + y], m2_s[c * X + x], m3_s[z * C2 + c]
// over x in [xlo, xhi) for the C2 class rows of the block's group, wg the
// Walk of that group (C2 its rows, c0 the first of them). `done` hands the
// set back cleared, or clears it later: before the part's last slab every
// thread calls
// done.ahead(other, words, ns) with the other set (`words` words, the
// previous scan's) and the part's slab count; where ns > 1 a block barrier
// of this scan has passed by then, so every thread is done with the other
// set, and the scan after this one is the next to use it.
template <bool kGeneral, int kTiles, class Done>
__device__ __forceinline__ void walk_scans(const Walk& w, Done& done) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) uint64_t full_bar[2];
  // This block's class group: rows [c0, c0 + C2) of the CT, whose templates
  // start c0 rows on; the layout is the launch's (w.C2 rows a group). The
  // other instance's one group is the launch's Walk itself, read where it
  // lies, as the kernel before class groups read it.
  Walk moved = w;
  const int NG = kGeneral ? w.NG : 1;
  if (kGeneral) {
    moved.c0 = blockIdx.x % NG * w.C2;
    moved.C2 = min(w.C2, w.CT - moved.c0);
    if (w.qxz != nullptr) moved.qxz = w.qxz + (size_t)moved.c0 * w.X * w.Z;
    if (w.qyz != nullptr) moved.qyz = w.qyz + (size_t)moved.c0 * w.Y * w.Z;
    if (w.qxy != nullptr) moved.qxy = w.qxy + (size_t)moved.c0 * w.X * w.Y;
  }
  const Walk& wg = kGeneral ? moved : w;
  const int8_t* __restrict__ cube = w.cube;
  const int8_t* __restrict__ qxz = wg.qxz;
  const int8_t* __restrict__ qyz = wg.qyz;
  const int8_t* __restrict__ qxy = wg.qxy;
  const int B = w.B, X = w.X, Y = w.Y, Z = w.Z, C2 = wg.C2, XS = w.XS, vec = w.vec;
  const bool h1 = qxz != nullptr, h2 = qyz != nullptr, h3 = qxy != nullptr;
  const bool staged = kGeneral && w.staged;
  const Layout L = make_layout(XS, w.P, X, Y, Z, w.C2, h1, h2, h3, staged, kTiles);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kRows = kTiles * kMaxC2;  // class rows of the block's n-tiles
  int* qxy_s = smem + L.qxy;  // [slab of the part][kRows classes][KQ] words: 4 rows' bytes each, zeros past C2 and the slab

  // This block's part: slabs [s0, s1), x rows [xlo, xhi), of scans b0, b0 +
  // G, ...; its work units are (scan, slab of the part).
  const int P = w.P, G = gridDim.x / (P * NG), part = blockIdx.x / NG % P,
            b0 = blockIdx.x / (NG * P);
  const int s0 = part * L.nslab / P, s1 = (part + 1) * L.nslab / P, ns = s1 - s0;
  const int xlo = s0 * XS, xhi = min(X, s1 * XS);
  const int nscan = (B - b0 + G - 1) / G;
  const int U = nscan * ns;
  // Unit u goes to buffer u % 2. With whole 16-byte rows thread 0 asks for
  // it in one bulk copy that reports to full_bar[u % 2]; otherwise every
  // thread copies bytes and the block's next barrier publishes them.
  // Staged, thread 0 asks for unit u's runs in the staging area (free: the
  // block barrier after realign(u - 1) has passed), reporting to
  // full_bar[u % 2]; realign(u) then lays them out in the buffer.
  auto load_unit = [&](int u) {
    if ((vec || staged) && tid != 0) return;
    const int b = b0 + (u / ns) * G;
    const int x0 = (s0 + u % ns) * XS;
    const int xs = min(XS, X - x0);
    int* buf = smem + L.cube + (u & 1) * L.slab;
    const int8_t* src = cube + ((size_t)b * X + x0) * Y * Z;
    if (staged) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const void *from, *qfrom;
      const uint32_t n = superset(src, (uint32_t)(xs * Y * Z), from);
      uint32_t total = n;
      if (h1)
        for (int c = 0; c < C2; ++c)
          total += superset(qxz + ((size_t)c * X + x0) * Z, (uint32_t)(xs * Z), qfrom);
      int* area = smem + L.stage;
      mbar_expect_tx(&full_bar[u & 1], total);
      bulk_copy(area, from, n, &full_bar[u & 1]);
      if (h1)
        for (int c = 0; c < C2; ++c) {
          const uint32_t nq = superset(qxz + ((size_t)c * X + x0) * Z, (uint32_t)(xs * Z), qfrom);
          bulk_copy(area + L.stc + c * L.stq, qfrom, nq, &full_bar[u & 1]);
        }
    } else if (vec) {
      {
        // the buffer's readers are past the block barrier; order their reads
        // before the copy engine's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t bytes = (uint32_t)(xs * Y * Z);
        mbar_expect_tx(&full_bar[u & 1], bytes);
        bulk_copy(buf, src, bytes, &full_bar[u & 1]);
      }
    } else {
      copy_rows<kGeneral>(buf, src, xs * Y, Z, L.SW);
    }
  };

  // Staged: unit u's runs (in the staging area, landed) into the buffer:
  // its nr slab rows of Z bytes into rows of SW words and its qxz rows into
  // [x][c] rows of TW words, zero past Z; a warp a row, a lane 16 bytes.
  const uint32_t buf_s = smem_u32(smem + L.cube), run_s = smem_u32(smem + L.stage);
  const int SW = L.SW, TW = L.TW, sq = L.sq, stc = L.stc, stq = L.stq;
  const int cpr = SW / 4, cqr = TW / 4;  // 16-byte chunks of a slab row and of a qxz row
  const uint32_t m_cpr = div_magic(cpr), m_cqr = div_magic(cqr), m_c2 = div_magic(C2);
  auto realign = [=](int u) {
    const int b = b0 + (u / ns) * G;
    const int x0 = (s0 + u % ns) * XS;
    const int xs = min(XS, X - x0), kc = xs * Y * cpr, kq = h1 ? xs * C2 * cqr : 0;
    const int lead = (int)((uintptr_t)(cube + ((size_t)b * X + x0) * Y * Z) & 15);
#pragma unroll 2
    for (int i = tid; i < kc + kq; i += kThreads) {  // a thread a chunk, all rows at once
      if (i < kc) {
        const int r = div_by(i, cpr, m_cpr), j = i - r * cpr;
        move_chunk(buf_s + 4 * r * SW + 16 * j, run_s, lead + r * Z + 16 * j, Z - 16 * j);
      } else {  // chunk j of qxz row q = (x, c) of the slab
        const int i2 = i - kc, q = div_by(i2, cqr, m_cqr), j = i2 - q * cqr;
        const int x = div_by(q, C2, m_c2), c = q - x * C2;
        const int ql = (int)((uintptr_t)(qxz + ((size_t)c * X + x0) * Z) & 15);
        move_chunk(buf_s + 4 * (sq + q * TW) + 16 * j, run_s + 4 * (stc + c * stq),
                   ql + x * Z + 16 * j, Z - 16 * j);
      }
    }
  };

  if (tid == 0) {
    mbar_init(&full_bar[0], 1);
    mbar_init(&full_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (U > 0) load_unit(0);
  if (U > 1 && !staged) load_unit(1);
  // The part's templates, once per block (plain loads, overlapping the
  // first units).
  if (h1 && !staged) copy_templates<kGeneral>(smem + L.qxz, qxz, C2, X, xlo, xhi - xlo, Z, L.TW);
  if (h2) copy_templates<kGeneral>(smem + L.qyz, qyz, C2, Y, 0, Y, Z, L.TW);
  if (h3) {
    int8_t* d = reinterpret_cast<int8_t*>(qxy_s);
    const int KR = L.KQ * 4;  // rows a class row of a slab holds
    for (int i = tid; i < ns * kRows * KR; i += blockDim.x) {
      const int r = i % KR, c = (i / KR) % kRows, sl = i / (KR * kRows);
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
    if (staged) {
      // Unit u into the buffer (its last reader, the slab before, is past
      // the block barrier), then the staging area takes unit u + 1, whose
      // copy overlaps this slab's steps. (Two staging areas, the copies two
      // slabs ahead, left slabs 3 x rows wide at 43 x 31 x 351, not 5: 3.17
      // against 2.65 ms at B=4096 on an NVIDIA H100 80GB HBM3, 700.00 W,
      // utils/kernel_probe.py i8.)
      mbar_wait_bounded(&full_bar[u & 1], (u >> 1) & 1);
      realign(u);
      __syncthreads();
      if (u + 1 < U) load_unit(u + 1);
    }
    const int* buf = smem + L.cube + (staged ? 0 : (u & 1) * L.slab);
    const uint32_t buf_a = smem_u32(buf) + 16 * a_half;
    const uint32_t sq_a = smem_u32(buf + L.sq);  // staged: the slab's qxz rows

    // t1 / t2 on the tensor cores: this warp's run of steps.
    const int steps = last ? run_last.n : run_full.n;
    if (steps > 0) {
      const int nxt = (xs + 15) / 16;
      int tab = last ? run_last.tab : run_full.tab, tile = last ? run_last.tile : run_full.tile;
      int row = last ? run_last.row : run_full.row, half = last ? run_last.half : run_full.half;
      // Three accumulators a class tile take turns, so that consecutive mma
      // do not wait for each other; they are summed when a tile is left.
      int d[3][kTiles][4] = {};
      // Add this warp's D to the scan's table and clear it: element i of
      // class tile k is tile row g + 8 * (i / 2), class 8 * k + 2 * t + i % 2.
      auto flush = [&]() {
        int* dst = tab == 1 ? m1_s : m2_s + x0;
        const int stride = tab == 1 ? Y : X, rows = tab == 1 ? Y : xs;
#pragma unroll
        for (int k = 0; k < kTiles; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * tile + g + 8 * (i >> 1), c = 8 * k + 2 * t + (i & 1);
            if (c < C2 && r < rows)
              atomicAdd(&dst[c * stride + r], d[0][k][i] + d[1][k][i] + d[2][k][i]);
            d[0][k][i] = d[1][k][i] = d[2][k][i] = 0;
          }
      };
      for (int it = 0; it < steps; ++it) {
        // cube row of this lane's tile row (rows past the edge repeat the last)
        int cr, trow;
        uint32_t tq;
        if (tab == 1) {
          cr = row * Y + min(16 * tile + a_row, Y - 1);
          if (staged) {
            trow = row; tq = sq_a;
          } else {
            trow = x0 - xlo + row; tq = qxz_a;
          }
        } else {
          cr = min(16 * tile + a_row, xs - 1) * Y + row;
          trow = row; tq = qyz_a;
        }
        const int zc0 = half ? L.nk / 2 : 0, zc1 = half ? L.nk : L.nk / 2;
        uint32_t a_addr = buf_a + cr * pitch + zc0 * 32;
        // B of class tile k: rows 8 * k .. + 7 of the template row trow
        uint32_t b_addr[kTiles];
#pragma unroll
        for (int k = 0; k < kTiles; ++k)
          b_addr[k] = (8 * k + b_c < C2 ? tq + (trow * C2 + 8 * k + b_c) * tpitch + 16 * b_half
                                        : zero_a) +
                      zc0 * 32;
        for (int zc = zc0; zc < zc1; zc += 3, a_addr += 96) {
          uint32_t a[3][4], bq[3][kTiles][2];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (zc + j < zc1) {  // all fragments first, then the products
              ldmatrix_x4(a[j], a_addr + 32 * j);
#pragma unroll
              for (int k = 0; k < kTiles; ++k) ldmatrix_x2(bq[j][k], b_addr[k] + 32 * j);
            }
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (zc + j < zc1) {
#pragma unroll
              for (int k = 0; k < kTiles; ++k) mma_s8(d[j][k], a[j], bq[j][k]);
            }
#pragma unroll
          for (int k = 0; k < kTiles; ++k) b_addr[k] += 96;
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
      const int* qw = qxy_s + ((s - s0) * kRows + g) * L.KQ + t;  // class tile k: + 8 * k rows
      int da[kTiles][4] = {}, db[kTiles][4] = {};
      auto flush3 = [&]() {
#pragma unroll
        for (int k = 0; k < kTiles; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int z = 32 * zg + 4 * g + (i >> 1), c = 8 * k + 2 * t + (i & 1);
            if (c < C2) {
              if (z < Z) atomicAdd(&m3_s[z * C2 + c], da[k][i]);
              if (z + 2 < Z) atomicAdd(&m3_s[(z + 2) * C2 + c], db[k][i]);
            }
            da[k][i] = db[k][i] = 0;
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
#pragma unroll
        for (int k = 0; k < kTiles; ++k) {
          bq[0] = qw[8 * k * L.KQ + 8 * kc];
          bq[1] = qw[8 * k * L.KQ + 8 * kc + 4];
          mma_s8(da[k], fa, bq);
          mma_s8(db[k], fb, bq);
        }
        if (++kc == nkc) {
          flush3();
          kc = 0;
          ++zg;
        }
      }
      flush3();  // a group this warp leaves unfinished (zeros otherwise)
    }
    __syncthreads();  // the slab's sums are complete; its buffer is free

    if (u + 2 < U && !staged) load_unit(u + 2);
    if (++s == s1) {  // the scan's part is complete: hand its set over
      done(wg, b, m1_s, m2_s, m3_s, xlo, xhi);
      s = s0;
      b += G;
      set ^= 1;  // this set is next used two scans on, block barriers later
    }
  }
}

// Whole scans: every output element exactly once, by plain stores; each
// element is cleared by the thread that wrote it out, so no barrier.
template <bool kGeneral>
struct StoreTables {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void ahead(int*, int, int) {}
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int, int) const {
    const int n1 = w.C2 * w.Y, n2 = w.C2 * w.X, n3 = w.Z * w.C2;
    const size_t o1 = kGeneral ? rows_at(w, b, w.Y) : (size_t)b * n1;
    const size_t o2 = kGeneral ? rows_at(w, b, w.X) : (size_t)b * n2;
    for (int i = threadIdx.x; i < max(n3, max(n1, n2)); i += blockDim.x) {
      if (i < n1) { t1[o1 + i] = m1_s[i]; m1_s[i] = 0; }
      if (i < n2) { t2[o2 + i] = m2_s[i]; m2_s[i] = 0; }
      if (i < n3) { t3[kGeneral ? t3_at(w, b, i) : (size_t)b * n3 + i] = m3_s[i]; m3_s[i] = 0; }
    }
  }
};

// A part of a scan: its own t2 rows (x in [xlo, xhi)) by plain stores, its
// t1 and t3 partials added into zeroed outputs (int32 atomics, exact in any
// order; a zero partial is skipped).
template <bool kGeneral>
struct AddPart {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int xlo, int xhi) const {
    const int n1 = w.C2 * w.Y, n2 = w.C2 * w.X, n3 = w.Z * w.C2;
    const size_t o1 = kGeneral ? rows_at(w, b, w.Y) : (size_t)b * n1;
    const size_t o2 = kGeneral ? rows_at(w, b, w.X) : (size_t)b * n2;
    for (int i = threadIdx.x; i < max(n3, max(n1, n2)); i += blockDim.x) {
      if (i < n1) {
        if (m1_s[i]) atomicAdd(&t1[o1 + i], m1_s[i]);
        m1_s[i] = 0;
      }
      if (i < n2) {
        const int x = i % w.X;
        if (x >= xlo && x < xhi) t2[o2 + i] = m2_s[i];
        m2_s[i] = 0;
      }
      if (i < n3) {
        if (m3_s[i]) atomicAdd(&t3[kGeneral ? t3_at(w, b, i) : (size_t)b * n3 + i], m3_s[i]);
        m3_s[i] = 0;
      }
    }
  }
};

// The lookup kernel's epilogue: whole scans as the combo kernel's, parts
// otherwise (one walk either way).
template <bool kGeneral>
struct LookupTables {
  int* t1;
  int* t2;
  int* t3;
  __device__ __forceinline__ void ahead(int*, int, int) {}
  __device__ __forceinline__ void operator()(const Walk& w, int b, int* m1_s, int* m2_s,
                                             int* m3_s, int xlo, int xhi) {
    if (w.P == 1)
      StoreTables<kGeneral>{t1, t2, t3}(w, b, m1_s, m2_s, m3_s, xlo, xhi);
    else
      AddPart<kGeneral>{t1, t2, t3}(w, b, m1_s, m2_s, m3_s, xlo, xhi);
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
template <bool kGeneral>
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
      const size_t o = kGeneral ? slot * w.CT + w.c0 + c : slot * C2 + c;
      s1[o] = ok && y >= 0 && y < Y ? m1_s[c * Y + y] : 0;
      s2[o] = ok && x >= 0 && x < X ? m2_s[c * X + x] : 0;
      s3[o] = ok && z >= 0 && z < Z ? m3_s[z * C2 + c] : 0;
    }
  }
};

// sel: scan b's t1 and t2 stored whole, as StoreTables stores them, and of
// t3 only the T x C2 reads d3 = t3[k, c] of each slot's z index k (zero
// outside [0, Z), -1 included).
template <bool kGeneral>
struct SelTables {
  const int* kidx;
  int T;
  int* t1;
  int* t2;
  int* d3;

  __device__ __forceinline__ void operator()(const Walk& w, int b, const int* m1_s,
                                             const int* m2_s, const int* m3_s) const {
    const int C2 = w.C2, Z = w.Z, n1 = C2 * w.Y, n2 = C2 * w.X;
    const size_t o1 = kGeneral ? rows_at(w, b, w.Y) : (size_t)b * n1;
    const size_t o2 = kGeneral ? rows_at(w, b, w.X) : (size_t)b * n2;
    for (int i = threadIdx.x; i < max(n1, n2); i += blockDim.x) {
      if (i < n1) t1[o1 + i] = m1_s[i];
      if (i < n2) t2[o2 + i] = m2_s[i];
    }
    if (!kGeneral) {
      for (int i = threadIdx.x; i < T * C2; i += blockDim.x) {
        const int k = kidx[(size_t)b * T + i / C2];
        d3[(size_t)b * T * C2 + i] = k >= 0 && k < Z ? m3_s[k * C2 + i % C2] : 0;
      }
      return;
    }
    for (int i = threadIdx.x; i < T * C2; i += blockDim.x) {
      const size_t slot = (size_t)b * T + i / C2;
      const int k = kidx[slot];
      d3[slot * w.CT + w.c0 + i % C2] = k >= 0 && k < Z ? m3_s[k * C2 + i % C2] : 0;
    }
  }
};

// Outputs are scan-major int32 t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2).
template <bool kGeneral, int kTiles = 1>
__global__ void __launch_bounds__(kThreads, 1)
combo_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  StoreTables<kGeneral> done{t1, t2, t3};
  walk_scans<kGeneral, kTiles>(w, done);
}

template <bool kGeneral, int kTiles = 1>
__global__ void __launch_bounds__(kThreads, 1)
lookup_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  LookupTables<kGeneral> done{t1, t2, t3};
  walk_scans<kGeneral, kTiles>(w, done);
}

// The lookup kernel's plan and epilogue under a symbol of its own. The
// y-group of its weights is the TPU kernel's tiling and changes nothing
// here.
template <bool kGeneral, int kTiles = 1>
__global__ void __launch_bounds__(kThreads, 1)
grouped_tables_kernel(Walk w, int* __restrict__ t1, int* __restrict__ t2, int* __restrict__ t3) {
  LookupTables<kGeneral> done{t1, t2, t3};
  walk_scans<kGeneral, kTiles>(w, done);
}

// Outputs t1 (B, C2, Y), t2 (B, C2, X) and d3 (B, T, C2); kidx (B, T) int32.
template <bool kGeneral, int kTiles = 1>
__global__ void __launch_bounds__(kThreads, 1)
sel_tables_kernel(Walk w, const int* __restrict__ kidx, int T, int* __restrict__ t1,
                  int* __restrict__ t2, int* __restrict__ d3) {
  ReadThenClear<SelTables<kGeneral>> done{{kidx, T, t1, t2, d3}};
  walk_scans<kGeneral, kTiles>(w, done);
}

// Outputs s1, s2, s3 (B, T, C2); ijk (B, T, 3) int32.
template <bool kGeneral, int kTiles = 1>
__global__ void __launch_bounds__(kThreads, 1)
sel3_scores_kernel(Walk w, const int* __restrict__ ijk, const uint8_t* __restrict__ valid, int T,
                   int* __restrict__ s1, int* __restrict__ s2, int* __restrict__ s3) {
  ReadThenClear<ReadScores<kGeneral>> done{{ijk, valid, T, s1, s2, s3}};
  walk_scans<kGeneral, kTiles>(w, done);
}

// The n-tiles of a block of C2 class rows: those of its kernel instance (1,
// or kMaxTiles past one n-tile), which its layout holds.
__host__ __device__ inline int tiles_of(int C2) { return C2 > kMaxC2 ? kMaxTiles : 1; }

// The x-slab width of whole scans at C2 class rows a block on a route: the
// widest, balanced over the slabs, whose block fits the shared-memory
// maximum; 0 if no slab fits.
int width_on(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3, bool staged) {
  for (int XS = X; XS >= 1; --XS) {
    if (make_layout(XS, 1, X, Y, Z, C2, h1, h2, h3, staged, tiles_of(C2)).total <= kSmemMax) {
      const int nslab = (X + XS - 1) / XS;
      return (X + nslab - 1) / nslab;
    }
  }
  return 0;
}

// Rows of Z bytes that are not whole 16-byte units take the staged route
// wherever one class row fits it (its staging area costs a slab's bytes:
// at X = 43, Z = 351 up to about 120 y values); past that, and for an
// unaligned cube of whole units, slabs are copied with byte loads.
bool staged_route(int X, int Y, int Z, bool h1, bool h2, bool h3) {
  return Z % 16 != 0 && width_on(X, Y, Z, 1, h1, h2, h3, true) > 0;
}

// The x-slab width of whole scans at C2 class rows a block, on the route
// of these dims.
int slab_width(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  return width_on(X, Y, Z, C2, h1, h2, h3, staged_route(X, Y, Z, h1, h2, h3));
}

// Slabs at least this many x rows wide keep t2's 16-row tiles half full.
constexpr int kWideSlab = 8;

// The class rows of one block of kMaxTiles n-tiles that takes all C2 rows
// of a scan: C2, past one n-tile, where that block's whole-scan slabs are
// at least kWideSlab x rows wide (or the arena's X); 0 otherwise. Narrower
// slabs repeat t2's steps (16-row tiles of x) and template reads for every
// slab: at 18 rows (9 classes) the three class groups beat two blocks of 2
// n-tiles at slabs 8 rows wide and one block of 3 n-tiles at slabs 3 rows
// wide (utils/kernel_probe.py i8, variants two_blocks and tiles3_narrow;
// PERF.md section 6).
int tile_rows(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  return C2 > kMaxC2 && C2 <= kMaxTiles * kMaxC2 &&
         slab_width(X, Y, Z, C2, h1, h2, h3) >= min(X, kWideSlab) ? C2 : 0;
}

// The class rows of a class group: ceil(C2 / NG) for the fewest groups NG
// whose rows (at most kMaxC2) have a whole-scan slab width; 0 if not even
// one row has.
int group_rows(int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  for (int ng = (C2 + kMaxC2 - 1) / kMaxC2; ng <= C2; ++ng) {
    const int cg = (C2 + ng - 1) / ng;
    if (slab_width(X, Y, Z, cg, h1, h2, h3) > 0) return cg;
  }
  return 0;
}

// SMs of the current device; 0 on a CUDA error.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// Batches of at least this many scans an SM take one block a scan where
// tile_rows has one.
constexpr int kOneBlockScansPerSM = 5;

// Whether one block a scan (tile_rows) takes a batch of B scans sooner than
// the class groups (group_rows). Both hold one block an SM, so the one
// block walks B scans in rounds of SMs scans, NG groups in rounds of
// SMs / NG; a group block's rounds cost less at first (it copies fewer
// templates and does fewer rows' steps), the one block's later rounds cost
// less (it does a slab's cube-side work once for every row). On an H100 at
// 5 classes (C2 = 10, NG = 2, the default arena) the one block took 7-69%
// longer than the groups below 199 scans, 9-19% at 265-330 and 0-6% at
// 331-396, was within 3.5% either way at 199-264 and 528, and took no
// longer for any of the five kernels from 660 = 5 x 132 scans on (2-13%
// less from 792 on; utils/kernel_probe.py batches, PERF.md section 6).
bool one_block_pays(int B) {
  return B >= kOneBlockScansPerSM * sm_count();
}

// The class rows of a block of a scan at a batch of B scans: tile_rows's
// where it has them and one_block_pays, else group_rows's.
int batch_rows(int B, int X, int Y, int Z, int C2, bool h1, bool h2, bool h3) {
  const int one = tile_rows(X, Y, Z, C2, h1, h2, h3);
  const int rows = group_rows(X, Y, Z, C2, h1, h2, h3);
  return one > 0 && one_block_pays(B) ? one : rows;
}

// Fill `w` for a launch over CT class rows in groups of CG, with x-slabs XS
// wide and P parts a scan; false for shapes the kernels do not take.
bool make_walk(Walk& w, const void* cube, const void* qxz, const void* qyz, const void* qxy,
               int B, int X, int Y, int Z, int CT, int CG, int XS, int P) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || CT < 1 || CG < 1 || CG > kMaxTiles * kMaxC2 ||
      CG > CT || XS < 1 || XS > X || P < 1 || P > (X + XS - 1) / XS)
    return false;
  const bool staged = staged_route(X, Y, Z, qxz, qyz, qxy);
  if (make_layout(XS, P, X, Y, Z, CG, qxz, qyz, qxy, staged, tiles_of(CG)).total > kSmemMax)
    return false;
  w.cube = static_cast<const int8_t*>(cube);
  w.qxz = static_cast<const int8_t*>(qxz);
  w.qyz = static_cast<const int8_t*>(qyz);
  w.qxy = static_cast<const int8_t*>(qxy);
  w.B = B; w.X = X; w.Y = Y; w.Z = Z; w.C2 = CG; w.XS = XS; w.P = P;
  w.CT = CT; w.NG = (CT + CG - 1) / CG; w.c0 = 0;
  // Bulk copies need whole 16-byte rows from a 16-byte aligned cube (a slab
  // then starts and ends on 16 bytes) and at most 2^20 - 1 bytes a barrier.
  w.vec = Z % 16 == 0 && ((uintptr_t)cube & 15) == 0 && (long long)XS * Y * Z < (1 << 20);
  w.staged = staged;
  return true;
}

// A whole-scan walk (P = 1) under the class groups of batch_rows and their
// slab width; false for shapes the kernels do not take.
bool whole_scan_walk(Walk& w, const void* cube, const void* qxz, const void* qyz,
                     const void* qxy, int B, int X, int Y, int Z, int C2) {
  const int CG = batch_rows(B, X, Y, Z, C2, qxz, qyz, qxy);
  return CG > 0 && make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2, CG,
                             slab_width(X, Y, Z, CG, qxz, qyz, qxy), 1);
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

// Launch a kernel over `w` on `stream`, its instance `one` (one class
// group, bulk copies), `general` or, past one n-tile of class rows a block,
// `tiles`: G = min(B, resident / (NG * P)) scans at a time, one block a
// (class group, part), so every block stays resident and keeps one group
// and part. Returns cudaGetLastError(); the launch does not synchronise.
template <typename Kernel, typename... Ts>
int launch(Kernel one, Kernel general, Kernel tiles, const Walk& w, void* stream, Ts... outs) {
  const Kernel kernel = w.C2 > kMaxC2 ? tiles : w.NG > 1 || !w.vec ? general : one;
  const size_t smem = make_layout(w.XS, w.P, w.X, w.Y, w.Z, w.C2, w.qxz, w.qyz, w.qxy, w.staged,
                                  tiles_of(w.C2)).total;
  cudaError_t err;
  const int resident = resident_blocks(kernel, smem, err);
  if (err != cudaSuccess) return (int)err;
  const int G = min(w.B, max(1, resident / (w.NG * w.P)));
  kernel<<<G * w.NG * w.P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(w, outs...);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` resident at once when it takes whole scans of a batch
// of B under batch_rows, over every class group (the batch at and above
// which the work plan does not cut scans is this over the groups), or minus
// a CUDA error (cudaErrorInvalidValue for shapes it does not take).
template <typename Kernel>
int whole_scan_resident(Kernel one, Kernel general, Kernel tiles, int B, int X, int Y, int Z,
                        int C2, int h1, int h2, int h3) {
  const int CG = C2 < 1 ? 0 : batch_rows(B, X, Y, Z, C2, h1, h2, h3);
  if (CG == 0) return -(int)cudaErrorInvalidValue;
  const Kernel kernel = CG > kMaxC2 ? tiles : CG < C2 || Z % 16 ? general : one;
  cudaError_t err;
  const int XS = slab_width(X, Y, Z, CG, h1, h2, h3);
  const bool staged = staged_route(X, Y, Z, h1, h2, h3);
  const int n = resident_blocks(
      kernel, make_layout(XS, 1, X, Y, Z, CG, h1, h2, h3, staged, tiles_of(CG)).total, err);
  return err == cudaSuccess ? n : -(int)err;
}

// Launch a tables kernel that takes the work plan (XS, P) from the host.
// Every element is written: at P > 1 t1 and t3 are first zeroed on
// `stream`, and the parts add into them.
template <typename Kernel>
int split_tables(Kernel one, Kernel general, Kernel tiles, const void* cube, const void* qxz,
                 const void* qyz, const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                 int Y, int Z, int C2, int XS, int P, void* stream) {
  Walk w;
  const int CG = C2 < 1 ? 0 : batch_rows(B, X, Y, Z, C2, qxz, qyz, qxy);
  if (CG == 0 || XS > slab_width(X, Y, Z, CG, qxz, qyz, qxy) ||
      !make_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2, CG, XS, P))
    return (int)cudaErrorInvalidValue;
  if (P > 1) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(t1, 0, sizeof(int) * B * C2 * Y, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(t3, 0, sizeof(int) * B * Z * C2, s);
    if (err != cudaSuccess) return (int)err;
  }
  return launch(one, general, tiles, w, stream, static_cast<int*>(t1), static_cast<int*>(t2),
                static_cast<int*>(t3));
}

}  // namespace

extern "C" {

// The rows of a block of a scan at a batch of B scans (batch_rows); 0 for
// shapes the kernels do not take, which ops/i8_score.card_operands refuses
// before any launch.
int i8_score_batch_rows(int B, int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return C2 < 1 ? 0 : batch_rows(B, X, Y, Z, C2, h1, h2, h3);
}

// The x-slab width of whole scans of a batch of B under batch_rows (exposed
// so the wrapper can report it and plan the lookup and glookup kernels'
// parts); 0 for shapes the kernels do not take.
int i8_score_batch_width(int B, int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  const int CG = i8_score_batch_rows(B, X, Y, Z, C2, h1, h2, h3);
  return CG == 0 ? 0 : slab_width(X, Y, Z, CG, h1, h2, h3);
}

// whole_scan_resident of the lookup and the glookup kernel at a batch of B.
int i8_score_lookup_resident_at(int B, int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return whole_scan_resident(lookup_tables_kernel<false>, lookup_tables_kernel<true>,
                             lookup_tables_kernel<true, kMaxTiles>, B, X, Y, Z, C2, h1, h2, h3);
}
int i8_score_grouped_resident_at(int B, int X, int Y, int Z, int C2, int h1, int h2, int h3) {
  return whole_scan_resident(grouped_tables_kernel<false>, grouped_tables_kernel<true>,
                             grouped_tables_kernel<true, kMaxTiles>, B, X, Y, Z, C2, h1, h2, h3);
}

// The combo kernel on `stream`: whole scans. Outputs are scan-major int32
// t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2), every element written.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for shapes the kernel does not take); the launch does not synchronise.
int i8_score_onepass_tables(const void* cube, const void* qxz, const void* qyz,
                            const void* qxy, void* t1, void* t2, void* t3, int B,
                            int X, int Y, int Z, int C2, void* stream) {
  Walk w;
  if (!whole_scan_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2)) return (int)cudaErrorInvalidValue;
  return launch(combo_tables_kernel<false>, combo_tables_kernel<true>,
                combo_tables_kernel<true, kMaxTiles>, w, stream,
                static_cast<int*>(t1), static_cast<int*>(t2), static_cast<int*>(t3));
}

// The lookup and glookup kernels: the same tables, each scan cut into P
// parts of x-slabs XS wide (1 <= P <= the slab count; XS at most the
// whole-scan width).
int i8_score_lookup_tables(const void* cube, const void* qxz, const void* qyz,
                           const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                           int Y, int Z, int C2, int XS, int P, void* stream) {
  return split_tables(lookup_tables_kernel<false>, lookup_tables_kernel<true>,
                      lookup_tables_kernel<true, kMaxTiles>, cube, qxz, qyz, qxy, t1, t2, t3, B,
                      X, Y, Z, C2, XS, P, stream);
}
int i8_score_grouped_tables(const void* cube, const void* qxz, const void* qyz,
                            const void* qxy, void* t1, void* t2, void* t3, int B, int X,
                            int Y, int Z, int C2, int XS, int P, void* stream) {
  return split_tables(grouped_tables_kernel<false>, grouped_tables_kernel<true>,
                      grouped_tables_kernel<true, kMaxTiles>, cube, qxz, qyz, qxy, t1, t2, t3, B,
                      X, Y, Z, C2, XS, P, stream);
}

// The sel kernel: whole scans; t1 (B, C2, Y) and t2 (B, C2, X) and the
// selected z-table reads d3 (B, T, C2) of the int32 kidx (B, T); every
// output element is written.
int i8_score_sel_tables(const void* cube, const void* qxz, const void* qyz, const void* qxy,
                        const void* kidx, void* t1, void* t2, void* d3, int B, int X, int Y,
                        int Z, int C2, int T, void* stream) {
  Walk w;
  if (T < 0 || !whole_scan_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2))
    return (int)cudaErrorInvalidValue;
  return launch(sel_tables_kernel<false>, sel_tables_kernel<true>,
                sel_tables_kernel<true, kMaxTiles>, w, stream,
                static_cast<const int*>(kidx), T, static_cast<int*>(t1), static_cast<int*>(t2),
                static_cast<int*>(d3));
}

// The sel3 kernel: whole scans; the three selected reads s1, s2, s3
// (B, T, C2) of the int32 ijk (B, T, 3); `valid` (B, T) bytes or null;
// every output element is written.
int i8_score_sel3_scores(const void* cube, const void* qxz, const void* qyz, const void* qxy,
                         const void* ijk, const void* valid, void* s1, void* s2, void* s3,
                         int B, int X, int Y, int Z, int C2, int T, void* stream) {
  Walk w;
  if (T < 0 || !whole_scan_walk(w, cube, qxz, qyz, qxy, B, X, Y, Z, C2))
    return (int)cudaErrorInvalidValue;
  return launch(sel3_scores_kernel<false>, sel3_scores_kernel<true>,
                sel3_scores_kernel<true, kMaxTiles>, w, stream,
                static_cast<const int*>(ijk), static_cast<const uint8_t*>(valid), T,
                static_cast<int*>(s1), static_cast<int*>(s2), static_cast<int*>(s3));
}

}  // extern "C"
