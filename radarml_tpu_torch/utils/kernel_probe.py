"""Where the hand-written kernels spend their time: a probe for the card.

    python3 -m radarml_tpu_torch.utils.kernel_probe [rbf] [i8] [tails] [batches] [native] [mma] [traces] [--earlier FILE.cu]

It builds variants of `ops/csrc/rbf_gram.cu`, `ops/csrc/i8_score.cu` and
`ops/csrc/native_score.cu` by patching their text (every patch must match the committed source
exactly once, so a stale patch fails loudly), compiles each with the
port's nvcc flags into a temporary directory, and prints device times
from a torch.profiler trace, beside the card's name and power limit.
Nothing here is on a serving path; it needs a CUDA card and nvcc.

rbf (serving shape 16,384 x 1,823 x 10,010 and 1824^2 x 10,010, uniform
rows, the support vectors exact copies of queries; the error against
float64 is taken on the 1824 equal rows' Gram at gamma 0.1):
  as_committed        the kernel as it is
  no_adds             the consumers do not add finished stages to their tile
  one_wgmma           hi * hi only: one wgmma a k-step instead of three
  no_loads            the producer signals a stage without copying it
  terms_side_by_side  a k-step's three terms one after the other instead of
                      the stage's eight small terms first: its error shows
                      what the tensor core's truncation costs
  kstep_from_zero     the tensor core sums one k-step (8 columns) from zero
                      and every k-step is added round to nearest, two in
                      flight: less error, four times the adds
i8 (the combo kernel of i8_score.cu; B = 4096 and 64, at the default arena
with 6, 9, 10 and 18 class rows (3, 9 at levels 1, 5 and 9 classes) and at
43 x 31 x 351, the staged route, with 6 and 18; each case's plan, blocks a
scan and slab width, as the build reports it; each variant's registers and
spills as ptxas reports them):
  as_committed  the kernel as it is
  loads_only    no t1 / t2 / t3 steps: the slab pipeline alone
  no_realign    the staged route without its realignment (other tables)
  warps_24      24 warps a block instead of 16
  two_blocks    past 16 class rows two blocks of 2 n-tiles a scan at the
                widest slabs that fit, in place of class groups
  tiles3        every block on an instance of 3 n-tiles (its rows past C2
                zero): at 6 class rows the work of one block of 24 rows,
                at the slabs of 6 (11 x rows wide at the default arena)
  tiles3_narrow the same at slabs at most 3 x rows wide
  clocks        clock64 around the phases of a slab, summed over the
                blocks by warp 0 and warp 15: clocks per slab of a block,
                and per scan over the blocks that share it
  earlier       with --earlier FILE.cu, that source (the same C interface)
                under each variant, with the variant's patches that it
                holds (an earlier source lacks later lines)
tails (the lookup, glookup, sel and sel3 kernels, which share the combo
kernel's walk; the same shapes, 4 target slots a scan for sel and sel3),
beside the combo kernel in the same build: device ms at B = 4096 and 64,
as_committed, loads_only (the i8 patches of that name) and sel3_barrier
(sel and sel3, whose epilogues share the clearing code, read, wait at a
block barrier and clear their set in the epilogue instead of ahead of the
next scan's last slab); the lookup and glookup kernels also at B = 1, 7,
100, 131, 132 and 133 under ops/i8_tails.lookup_plan, and the lookup
kernel under other plans, each checked against the committed plan's
tables: B = 64 with 3 parts (resident / B rounded up), B = 100 and 131
with whole scans
batches (the five int8 kernels at 5 classes on the default arena, C2 =
10, over batches of 1 to 4096 scans, one block of two n-tiles a scan
against two class groups: one_block and groups force the plan at every
batch, as_committed takes the committed rule, earlier is --earlier's
source; and, with --earlier, 43 x 31 x 351 with 6 rows at B = 4096, the
committed source beside the earlier one)
native (B7; 3 random classes, B = 4096 and 64, at the default arena and at
43 x 31 x 351, the long-row instance; each variant's registers and spills
as ptxas reports them, and its largest |error| against the plain version):
  as_committed    the kernel as it is
  warps_8         8 consumer warps a block at every C (16 up to C = 3 as
                  committed)
  loads_only      the consumer warps skip the rows' FMAs: the ring, the
                  sums over the warps and the m3 turns without the rows
  handshake_only  the consumer warps release each stage as it lands: the
                  producer and the copies alone
  one_slab        one x-slab a stage (8 stages at this shape) instead of 3
  branch_free     the row loop's lanes past the row's last pair load pair 0
                  and use a zero word instead of branching around the pair
  clocks          clock64 around the phases of a slab, summed over the
                  blocks by the first and last consumer warps and the
                  producer: clocks per slab
  earlier       FILE.cu given with --earlier (a source with the same C
                interface, e.g. an earlier version of the kernel)
mma: the int8 mma.sync m16n8k32 rate (the table kernels' instruction), a
register-only loop on every SM at 16, 8 and 4 warps an SM with 1, 4 and 8
independent accumulators a warp: TOPS and SM clocks an mma.
traces: how often a profiler trace, taken as kernel_device_ms takes it,
lacks the records of a kernel that ran in it: 40 traces each of B7 at
B = 64 (one launch ~0.04 ms) with 1 and with 20 launches.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from radarml_tpu_torch.ops import _cuda_build, i8_score, i8_tails, rbf, score
from radarml_tpu_torch.utils import profiling
from radarml_tpu_torch.utils.profiling import kernel_device_ms


def patched(text: str, patches) -> str:
    """`text` with every (old, new) applied; each old must occur once."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch matches {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variant_sources(name: str, variants: dict) -> dict:
    """variant -> the text of csrc/<name>.cu under that variant's patches."""
    source = (_cuda_build.CSRC / f"{name}.cu").read_text()
    return {variant: patched(source, patches) for variant, patches in variants.items()}


def build_variants(name: str, variants: dict, tmp: Path, texts=None, logs=None) -> dict:
    """Compile csrc/<name>.cu under each variant's patches (and each
    variant -> source text in `texts` as it is), one nvcc each, all started
    together; returns variant -> ctypes library. With a dict `logs`, the
    build adds -Xptxas -v and puts each variant's compiler output there."""
    sources = variant_sources(name, variants) | dict(texts or {})
    extra = ["-Xptxas", "-v"] if logs is not None else []
    procs = {}
    for variant, text in sources.items():
        src = tmp / f"{name}_{variant}.cu"
        src.write_text(text)
        out = tmp / f"lib{name}_{variant}.so"
        procs[variant] = (out, subprocess.Popen(
            [_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS, *extra, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} variant {variant}:\n{log}")
        if logs is not None:
            logs[variant] = log
        libs[variant] = ctypes.CDLL(str(out))
    return libs


def device_ms(fn, symbol: str, reps: int) -> float:
    """Mean device ms of the kernel named `symbol` over `reps` calls of fn."""
    return kernel_device_ms({"k": fn}, {"k": symbol}, reps)["k"]


_SMALL_TERMS = (
    "#pragma unroll\n"
    "  for (int ks = 0; ks < 4; ++ks) {\n"
    "    const uint64_t k_off = (uint64_t)((ks * 8 * 4) >> 4);  // 8 columns on, in 16 bytes\n"
    "    wgmma_m64n128k8(acc, f[ks].lo[0], f[ks].lo[1], f[ks].lo[2], f[ks].lo[3], b_hi + k_off,\n"
    "                    ks > 0);\n"
    "    wgmma_m64n128k8(acc, f[ks].hi[0], f[ks].hi[1], f[ks].hi[2], f[ks].hi[3], b_lo + k_off, 1);\n"
    "  }\n")
_LARGE_TERM = (
    "    wgmma_m64n128k8(acc, f[ks].hi[0], f[ks].hi[1], f[ks].hi[2], f[ks].hi[3], b_hi + k_off, 1);\n")
_STAGE = (
    "        queue_stage(part, f, b_hi, b_lo);\n"
    "        wgmma_wait<0>();\n"
    "        retire_stage(part, mid);\n")
RBF_VARIANTS = {
    "as_committed": [],
    "no_adds": [("#pragma unroll\n  for (int i = 0; i < 64; ++i) mid[i] += acc[i];\n",
                 "  (void)mid;\n")],
    "one_wgmma": [
        (_SMALL_TERMS, ""),
        (_LARGE_TERM, _LARGE_TERM.replace("b_hi + k_off, 1);", "b_hi + k_off, ks > 0);")),
    ],
    "no_loads": [(
        "          mbar_expect_tx(&full_bar[stage], kStageBytes);\n"
        "          bulk_copy(st, a + (size_t)c * kTileFloats, kABytes, &full_bar[stage]);\n"
        "          bulk_copy(st + kABytes, b + (size_t)c * (2 * kTileFloats), kBBytes, "
        "&full_bar[stage]);\n",
        "          (void)a; (void)b; (void)st;\n"
        "          mbar_arrive(&full_bar[stage]);\n")],
    "terms_side_by_side": [
        (_SMALL_TERMS, ""),
        (_LARGE_TERM,
         "    wgmma_m64n128k8(acc, f[ks].lo[0], f[ks].lo[1], f[ks].lo[2], f[ks].lo[3], "
         "b_hi + k_off, ks > 0);\n"
         "    wgmma_m64n128k8(acc, f[ks].hi[0], f[ks].hi[1], f[ks].hi[2], f[ks].hi[3], "
         "b_lo + k_off, 1);\n" + _LARGE_TERM),
    ],
    "kstep_from_zero": [
        ("// Add a finished stage to the second level, round to nearest.\n",
         "__device__ __forceinline__ void queue_kstep(float (&acc)[64], const Fragment& f, int ks,\n"
         "                                            uint64_t b_hi, uint64_t b_lo) {\n"
         "  const uint64_t k_off = (uint64_t)((ks * 8 * 4) >> 4);\n"
         "  fence_tile(acc);\n"
         "  wgmma_fence();\n"
         "  wgmma_m64n128k8(acc, f.lo[0], f.lo[1], f.lo[2], f.lo[3], b_hi + k_off, 0);\n"
         "  wgmma_m64n128k8(acc, f.hi[0], f.hi[1], f.hi[2], f.hi[3], b_lo + k_off, 1);\n"
         "  wgmma_m64n128k8(acc, f.hi[0], f.hi[1], f.hi[2], f.hi[3], b_hi + k_off, 1);\n"
         "  wgmma_commit();\n"
         "}\n\n"
         "// Add a finished stage to the second level, round to nearest.\n"),
        ("    float part[64], mid[64];\n", "    float part[64], mid[64], p1[64];\n"),
        ("    for (int i = 0; i < 64; ++i) part[i] = mid[i] = 0.f;\n",
         "    for (int i = 0; i < 64; ++i) part[i] = mid[i] = p1[i] = 0.f;\n"),
        (_STAGE,
         "        queue_kstep(part, f[0], 0, b_hi, b_lo);\n"
         "        queue_kstep(p1, f[1], 1, b_hi, b_lo);\n"
         "        wgmma_wait<1>();\n"
         "        retire_stage(part, mid);\n"
         "        queue_kstep(part, f[2], 2, b_hi, b_lo);\n"
         "        wgmma_wait<1>();\n"
         "        retire_stage(p1, mid);\n"
         "        queue_kstep(p1, f[3], 3, b_hi, b_lo);\n"
         "        wgmma_wait<1>();\n"
         "        retire_stage(part, mid);\n"
         "        wgmma_wait<0>();\n"
         "        retire_stage(p1, mid);\n"),
    ],
}


def probe_rbf(tmp: Path) -> None:
    libs = build_variants("rbf_gram", RBF_VARIANTS, tmp)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.rand((16384, 10010), generator=gen, device=dev)
    s = q[torch.randint(0, q.shape[0], (1823,), generator=gen, device=dev)].contiguous()
    x = q[:1824].contiguous()
    x64 = x.double()
    d2 = ((x64 * x64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
          - 2.0 * (x64 @ x64.T)).clamp(min=0.0)
    oracle = torch.exp(-0.1 * d2)
    for variant, lib in libs.items():
        rbf._bind(lib)

        def gram(A, B_, gamma, lib=lib):
            n, F = A.shape
            m = B_.shape[0]
            nbytes = lib.rbf_gram_workspace_bytes(n, m, F)
            out = torch.empty((n, m), dtype=torch.float32, device=dev)
            work = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
            err = lib.rbf_gram_f32(A.data_ptr(), B_.data_ptr(), out.data_ptr(), work.data_ptr(),
                                   nbytes, n, m, F, gamma,
                                   torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"rbf_gram_f32 launch failed: CUDA error {err}")
            return out

        err = float((gram(x, x, 0.1).double() - oracle).abs().max())
        torch.cuda.synchronize()
        print(f"rbf {variant}: gram kernel {device_ms(lambda: gram(q, s, 0.01), 'rbf_gram_kernel', 3):.4f} "
              f"ms at {tuple(q.shape)}x{s.shape[0]}, "
              f"{device_ms(lambda: gram(x, x, 0.01), 'rbf_gram_kernel', 3):.4f} ms at "
              f"{tuple(x.shape)}x{x.shape[0]}; max |K - K64| on equal uniform rows, gamma 0.1: "
              f"{err:.3e}", flush=True)


I8_SKIP = [("    if (steps > 0) {\n", "    if (steps > 0 && B < 0) {\n"),
           ("    if (steps3 > 0) {\n", "    if (steps3 > 0 && B < 0) {\n")]
# the plan of one block of several n-tiles a scan, against narrower slabs
_TILES3 = [("constexpr int kMaxTiles = 2;", "constexpr int kMaxTiles = 3;"),
           ("__host__ __device__ inline int tiles_of(int C2) { return C2 > kMaxC2 ? kMaxTiles : 1; }",
            "__host__ __device__ inline int tiles_of(int C2) { return kMaxTiles; }"),
           ("  const Kernel kernel = w.C2 > kMaxC2 ? tiles : w.NG > 1 || !w.vec ? general : one;",
            "  const Kernel kernel = tiles;")]
_ONE_BLOCK = ("  return C2 > kMaxC2 && C2 <= kMaxTiles * kMaxC2 &&\n"
              "         slab_width(X, Y, Z, C2, h1, h2, h3) >= min(X, kWideSlab) ? C2 : 0;\n")
I8_TICK = (
    "#define TICK(k) if (lane == 0 && (warp == 0 || warp == kWarps - 1)) { "
    "long long n_ = clock64(); atomicAdd(&probe_clk[(warp ? 8 : 0) + (k)], "
    "(unsigned long long)(n_ - t_)); t_ = n_; }\n")
I8_VARIANTS = {
    "as_committed": [],
    "loads_only": I8_SKIP,
    "no_realign": [("      realign(u);\n", "      if (B < 0) realign(u);\n")],
    "warps_24": [("constexpr int kThreads = 512;", "constexpr int kThreads = 768;")],
    # past 16 class rows, two blocks of 2 n-tiles a scan at the widest slabs
    # that fit (8 x rows at 9 rows a block) instead of class groups
    "two_blocks": [(_ONE_BLOCK, "  return C2 <= kMaxC2 ? 0 : C2 <= kMaxTiles * kMaxC2 ? C2 "
                              ": (C2 + 1) / 2;\n")],
    # every block on an instance of 3 n-tiles (the class rows past C2 zero):
    # one block's work for up to 24 rows, at the slab width of the rows it
    # holds, and at slabs at most 3 x rows wide
    "tiles3": _TILES3,
    "tiles3_narrow": _TILES3 + [(
        "  for (int XS = X; XS >= 1; --XS) {\n"
        "    if (make_layout(XS, 1, X, Y, Z, C2, h1, h2, h3, staged, tiles_of(C2)).total",
        "  for (int XS = min(X, 3); XS >= 1; --XS) {\n"
        "    if (make_layout(XS, 1, X, Y, Z, C2, h1, h2, h3, staged, tiles_of(C2)).total")],
    "clocks": [
        ("namespace {\n\nconstexpr int kMaxC2",
         "namespace {\n__device__ unsigned long long probe_clk[16];\n" + I8_TICK
         + "\nconstexpr int kMaxC2"),
        ("  int b = b0, s = s0, set = 0;",
         "  long long t_ = clock64();\n  int b = b0, s = s0, set = 0;"),
        ("    if (vec) mbar_wait(&full_bar[u & 1], (u >> 1) & 1);  // unit u has landed\n",
         "    TICK(0)\n    if (vec) mbar_wait(&full_bar[u & 1], (u >> 1) & 1);\n    TICK(1)\n"),
        ("    // t3 on the tensor cores: D[z, c]", "    TICK(2)\n    // t3 on the tensor cores: D[z, c]"),
        ("    __syncthreads();  // the slab's sums are complete; its buffer is free\n",
         "    TICK(3)\n    __syncthreads();\n    TICK(4)\n"),
        ("      mbar_wait_bounded(&full_bar[u & 1], (u >> 1) & 1);\n      realign(u);\n"
         "      __syncthreads();\n",
         "      mbar_wait_bounded(&full_bar[u & 1], (u >> 1) & 1);\n      TICK(6)\n"
         "      realign(u);\n      __syncthreads();\n      TICK(7)\n"),
        ("      set ^= 1;  // this set is next used two scans on, block barriers later\n    }\n",
         "      set ^= 1;\n    }\n    TICK(5)\n"),
        ('extern "C" {\n\n// The ',
         'extern "C" {\nint i8_score_probe_clocks(unsigned long long* out, int clear) {\n'
         "  unsigned long long z[16] = {};\n"
         "  if (clear) return (int)cudaMemcpyToSymbol(probe_clk, z, sizeof(z));\n"
         "  return (int)cudaMemcpyFromSymbol(out, probe_clk, sizeof(z));\n}\n\n"
         "// The "),
    ],
}


# (dims, class rows) of the i8 probe: 3, 5 and 9 classes at levels 2 on the
# default arena, 3 and 9 at 43 x 31 x 351
I8_CASES = (((22, 31, 176), 6), ((22, 31, 176), 9), ((22, 31, 176), 10), ((22, 31, 176), 18),
            ((43, 31, 351), 6), ((43, 31, 351), 18))


def earlier_variants(variants: dict, earlier) -> dict:
    """"earlier <variant>" -> the text of the source file `earlier` under
    the patches of that variant that it holds (an earlier source lacks the
    lines of later code), for each variant of which it holds at least one
    patch or none is asked; a patch that matches more than once raises."""
    if not earlier:
        return {}
    text = Path(earlier).read_text()
    out = {}
    for variant, patches in variants.items():
        held = [(old, new) for old, new in patches if text.count(old)]
        if held or not patches:
            out[f"earlier {variant}"] = patched(text, held)
    return out


def probe_i8(tmp: Path, earlier=None) -> None:
    logs = {}
    libs = build_variants("i8_score", I8_VARIANTS, tmp, earlier_variants(I8_VARIANTS, earlier),
                          logs)
    for variant in libs:
        print(f"i8 {variant} (ptxas):\n  {ptxas_lines(logs[variant], 'combo_tables_kernel')}",
              flush=True)
    for dims, C2 in I8_CASES:
        probe_i8_at(libs, dims, C2)


def probe_i8_at(libs: dict, dims, C2: int) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z = dims
    q = [torch.randint(-127, 128, (C2,) + sh, generator=gen, device=dev, dtype=torch.int8)
         for sh in ((X, Z), (Y, Z), (X, Y))]
    cube = torch.randint(-128, 128, (4096, X, Y, Z), generator=gen, device=dev, dtype=torch.int8)
    want = None
    for variant, lib in libs.items():
        i8_score._bind(lib)

        def tables(B, lib=lib):
            t = [torch.empty(sh, dtype=torch.int32, device=dev)
                 for sh in ((B, C2, Y), (B, C2, X), (B, Z, C2))]
            err = lib.i8_score_onepass_tables(
                cube.data_ptr(), *[t_.data_ptr() for t_ in q], *[t_.data_ptr() for t_ in t],
                B, X, Y, Z, C2, torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"i8_score_onepass_tables launch failed: CUDA error {err}")
            return t

        if variant == "as_committed":
            want = tables(4096)
        same = all(torch.equal(a, b) for a, b in zip(tables(4096), want))
        rows, width = lib_plan(lib, dims, C2, 4096)
        blocks = -(-C2 // rows)
        line = (f"i8 {variant} at {dims} C2={C2} ({blocks} blocks a scan, slabs {width} x "
                f"rows wide): device "
                f"{device_ms(lambda: tables(4096), 'combo_tables_kernel', 20):.4f} ms at B=4096, "
                f"{device_ms(lambda: tables(64), 'combo_tables_kernel', 20):.4f} ms at B=64"
                f"{'' if same else ' (other tables: the variant drops work)'}")
        if variant.endswith("clocks"):
            lib.i8_score_probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
            out = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.i8_score_probe_clocks(None, 1)
            tables(4096)
            torch.cuda.synchronize()
            lib.i8_score_probe_clocks(out, 0)
            slabs = 4096 * -(-X // width) * blocks  # slabs the blocks walked
            names = ("loop top", "wait for the slab", "t1/t2 steps", "t3 steps",
                     "barrier", "write-out", "staged wait", "realign and barrier")
            for base, who in ((0, "warp 0"), (8, "warp 15")):
                line += (f"; {who} clocks per slab of a block: "
                         + ", ".join(f"{n} {out[base + k] / slabs:.0f}"
                                     for k, n in enumerate(names))
                         + f" (sum {sum(out[base:base + 8]) / slabs:.0f}; per scan over its "
                         f"{blocks} blocks {sum(out[base:base + 8]) / 4096:.0f})")
        print(line, flush=True)


TAILS_VARIANTS = {
    "as_committed": [],
    "loads_only": I8_SKIP,
    # sel and sel3 read, wait at a block barrier and clear in their epilogue
    # instead of clearing each set ahead of the next scan's last slab
    "sel3_barrier": [("    cleared_ahead = ns > 1;\n", "    cleared_ahead = false;\n")],
}


def lib_plan(lib, dims, c2: int, B: int) -> tuple:
    """(rows a block, slab width) of the int8 kernels' whole-scan plan at
    a batch of B scans, every plane present, as a built library reports it
    (i8_score_batch_rows, i8_score_batch_width), or as an earlier source's
    does, whose plan has no batch (i8_score_group_rows,
    i8_score_slab_width)."""
    if hasattr(lib, "i8_score_batch_rows"):
        return (lib.i8_score_batch_rows(B, *dims, c2, 1, 1, 1),
                lib.i8_score_batch_width(B, *dims, c2, 1, 1, 1))
    return (lib.i8_score_group_rows(*dims, c2, 1, 1, 1),
            lib.i8_score_slab_width(*dims, c2, 1, 1, 1))


def lib_resident(lib, kernel: str, dims, c2: int, B: int) -> int:
    """Resident blocks of the lookup or glookup ("grouped") kernel's
    whole-scan plan at a batch of B, every plane present, as lib_plan
    asks them."""
    if hasattr(lib, "i8_score_batch_rows"):
        return getattr(lib, f"i8_score_{kernel}_resident_at")(B, *dims, c2, 1, 1, 1)
    return getattr(lib, f"i8_score_{kernel}_resident")(*dims, c2, 1, 1, 1)


I8_SYMBOLS = {"combo": "combo_tables_kernel", "lookup": "lookup_tables_kernel",
              "grouped": "grouped_tables_kernel", "sel": "sel_tables_kernel",
              "sel3": "sel3_scores_kernel"}


def int8_calls(lib, cube, q, ijk, B: int, plan=None) -> dict:
    """The five int8 kernels of a built library on the first B scans of
    `cube` (B, X, Y, Z) with templates q (qxz, qyz, qxy) and target slots
    ijk (B', T, 3): name (I8_SYMBOLS) -> call. The lookup and glookup
    kernels take `plan` (P, XS), by default ops/i8_tails.lookup_plan from
    the library's own resident blocks and slab width at this batch."""
    dev = cube.device
    X, Y, Z = cube.shape[1:]
    C2, T = q[0].shape[0], ijk.shape[1]
    dims = (X, Y, Z)
    kidx = ijk[:B, :, 2].contiguous()
    ijk = ijk[:B].contiguous()
    qp = [t_.data_ptr() for t_ in q]
    rows, width = lib_plan(lib, dims, C2, B)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def outs(*shapes):
        return [torch.empty(sh, dtype=torch.int32, device=dev) for sh in shapes]

    def run(fn, extra, o, *ints):
        err = getattr(lib, fn)(cube.data_ptr(), *qp, *extra, *[t_.data_ptr() for t_ in o],
                               B, X, Y, Z, C2, *ints, stream)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
        return o

    def split(kernel):
        resident = lib_resident(lib, kernel, dims, C2, B)
        P, XS = plan or i8_tails.lookup_plan(B, X, max(1, resident // -(-C2 // rows)), width)
        return lambda: run(f"i8_score_{kernel}_tables", (), outs(*tabs), XS, P)

    tabs = ((B, C2, Y), (B, C2, X), (B, Z, C2))
    return {"combo": lambda: run("i8_score_onepass_tables", (), outs(*tabs)),
            "lookup": split("lookup"), "grouped": split("grouped"),
            "sel": lambda: run("i8_score_sel_tables", (kidx.data_ptr(),),
                               outs(tabs[0], tabs[1], (B, T, C2)), T),
            "sel3": lambda: run("i8_score_sel3_scores", (ijk.data_ptr(), None),
                                outs(*[(B, T, C2)] * 3), T)}


def int8_operands(dims, C2: int, B: int = 4096, T: int = 4):
    """Random int8 templates (qxz, qyz, qxy) of C2 class rows, a cube of B
    scans and T target slots a scan at `dims`, on the card, seed 0."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z = dims
    q = [torch.randint(-127, 128, (C2,) + sh, generator=gen, device=dev, dtype=torch.int8)
         for sh in ((X, Z), (Y, Z), (X, Y))]
    cube = torch.randint(-128, 128, (B, X, Y, Z), generator=gen, device=dev, dtype=torch.int8)
    ijk = torch.stack([torch.randint(0, n, (B, T), generator=gen, device=dev)
                       for n in dims], -1).to(torch.int32)
    return q, cube, ijk


def probe_tails(tmp: Path) -> None:
    libs = build_variants("i8_score", TAILS_VARIANTS, tmp)
    dims, C2 = (22, 31, 176), 6
    X = dims[0]
    q, cube, ijk = int8_operands(dims, C2)
    for variant, lib in libs.items():
        i8_score._bind(lib)
        resident = {k: lib_resident(lib, k, dims, C2, 4096) for k in ("lookup", "grouped")}
        width = lib_plan(lib, dims, C2, 4096)[1]
        parts = []
        for name, symbol in I8_SYMBOLS.items():
            parts.append(f"{name} " + " / ".join(
                f"{device_ms(int8_calls(lib, cube, q, ijk, B)[name], symbol, 20):.4f}"
                for B in (4096, 64)))
        line = (f"tails {variant}: device ms at B=4096 / 64: " + ", ".join(parts)
                + f" (resident blocks {resident}, slab width {width})")
        if variant == "as_committed":
            sweep = []
            for B in (1, 7, 100, 131, 132, 133):
                P, XS = i8_tails.lookup_plan(B, X, resident["lookup"], width)
                calls = int8_calls(lib, cube, q, ijk, B)
                sweep.append(f"B={B} (P {P}, XS {XS}) "
                             f"{device_ms(calls['lookup'], 'lookup_tables_kernel', 20):.4f}"
                             f" / glookup "
                             f"{device_ms(calls['grouped'], 'grouped_tables_kernel', 20):.4f}")
            for B, plan in ((64, (3, 8)), (100, (1, width)), (131, (1, width))):
                forced = int8_calls(lib, cube, q, ijk, B, plan)["lookup"]
                if not all(torch.equal(a, b) for a, b in
                           zip(forced(), int8_calls(lib, cube, q, ijk, B)["lookup"]())):
                    raise AssertionError(f"lookup tables at B={B} differ under the plan {plan}")
                ms = device_ms(forced, "lookup_tables_kernel", 20)
                sweep.append(f"B={B} forced (P {plan[0]}, XS {plan[1]}) {ms:.4f}")
            line += "; lookup " + ", ".join(sweep)
        print(line, flush=True)


# the plan at every batch forced one way: one block of two n-tiles a scan
# (where tile_rows has one) or class groups
_RULE = "bool one_block_pays(int B) {\n"
BATCH_VARIANTS = {"one_block": [(_RULE, _RULE + "  if (B > 0) return true;\n")],
                  "groups": [(_RULE, _RULE + "  if (B > 0) return false;\n")]}
BATCH_SWEEP = (1, 33, 64, 66, 67, 96, 128, 132, 133, 160, 198, 199, 200, 264, 265, 330, 331,
               396, 528, 660, 792, 924, 1056, 1188, 1320, 1584, 2048, 2640, 4096)


def probe_batches(tmp: Path, earlier=None) -> None:
    """The five int8 kernels at 5 classes on the default arena (C2 = 10,
    where one block of two n-tiles a scan or two class groups take a
    scan) over BATCH_SWEEP: as committed, under BATCH_VARIANTS and, with
    --earlier, that source, interleaved at each batch in the order
    earlier, groups, one_block, as_committed, as_committed, one_block,
    groups, earlier, each variant's tables checked against the committed
    build's. Then at 43 x 31 x 351 with 6 rows (the staged route) and
    B = 4096 the committed build beside the earlier source, in the order
    earlier, as_committed, as_committed, earlier, four times."""
    texts = {"earlier": Path(earlier).read_text()} if earlier else {}
    libs = build_variants("i8_score", {"as_committed": []} | BATCH_VARIANTS, tmp, texts)
    for lib in libs.values():
        i8_score._bind(lib)
    order = [v for v in ("earlier", "groups", "one_block", "as_committed") if v in libs]
    order += order[::-1]

    def sweep(dims, C2, batches, order):
        q, cube, ijk = int8_operands(dims, C2, max(batches))
        for B in batches:
            calls = {v: int8_calls(libs[v], cube, q, ijk, B) for v in libs}
            want = {n: f() for n, f in calls["as_committed"].items()}
            for v in libs:
                for n, f in calls[v].items():
                    if not all(torch.equal(a, b) for a, b in zip(f(), want[n])):
                        raise AssertionError(f"{v} {n} at B={B}: other tables")
            times = {v: {n: [] for n in I8_SYMBOLS} for v in libs}
            for v in order:
                for n, ms in kernel_device_ms(calls[v], I8_SYMBOLS, 20).items():
                    times[v][n].append(ms)
            plans = ", ".join(f"{v} {lib_plan(libs[v], dims, C2, B)}" for v in libs)
            print(f"batches {dims} C2={C2} B={B} (rows a block, slab width: {plans}): device "
                  "ms a call, " + "; ".join(
                      f"{n} " + ", ".join(f"{v} " + "/".join(f"{x:.4f}" for x in times[v][n])
                                          for v in libs)
                      for n in I8_SYMBOLS), flush=True)

    sweep((22, 31, 176), 10, BATCH_SWEEP, order)
    if "earlier" in libs:
        libs = {v: libs[v] for v in ("as_committed", "earlier")}
        sweep((43, 31, 351), 6, (4096,), ["earlier", "as_committed", "as_committed", "earlier"] * 4)


_NATIVE_LOADS_ONLY = [("        if (y < Y)\n          row_step<C>(",
                       "        if (y < Y && B < 0)\n          row_step<C>("),
                      ("          if (y < Y) {\n            float t3[C];",
                       "          if (y < Y && B < 0) {\n            float t3[C];")]
_NATIVE_TICK = (
    "#define TICK(k) if (lane == 0 && (warp == 0 || warp == W - 1 || warp == W)) { "
    "long long n_ = clock64(); atomicAdd(&probe_clk[(warp == W ? 12 : warp ? 6 : 0) + (k)], "
    "(unsigned long long)(n_ - t_)); t_ = n_; }\n")
NATIVE_VARIANTS = {
    "as_committed": [],
    "warps_8": [("constexpr int kWideMaxC = 3;", "constexpr int kWideMaxC = 0;")],
    "loads_only": _NATIVE_LOADS_ONLY,
    "handshake_only": [(
        "    mbar_wait(&full[s], (u / L.NS) & 1);  // unit u has landed\n",
        "    mbar_wait(&full[s], (u / L.NS) & 1);\n    __syncwarp();\n"
        "    if (lane == 0) mbar_arrive(&empty[s]);\n    if (B > 0) continue;\n")],
    "one_slab": [("constexpr int kStageBytes = 32768;", "constexpr int kStageBytes = 1;")],
    "branch_free": [
        ("    if (k < KP && pair < ZP) {\n      const uint32_t w = cube[pair];\n",
         "    if (k < KP) {\n      const int pc = pair < ZP ? pair : 0;\n"
         "      const uint32_t w = pair < ZP ? cube[pc] : 0u;\n"),
        ("tyz_row + c * tyz_c + 2 * pair);", "tyz_row + c * tyz_c + 2 * pc);")],
    "clocks": [
        ("namespace {\n\nconstexpr int kMaxC",
         "namespace {\n__device__ unsigned long long probe_clk[16];\n" + _NATIVE_TICK
         + "\nconstexpr int kMaxC"),
        ("  __syncthreads();  // the only block-wide barrier\n",
         "  __syncthreads();\n  long long t_ = clock64();\n"),
        ("        mbar_wait(&empty[s], (round - 1) & 1);\n        take(u - L.NS);\n",
         "        TICK(3)\n        mbar_wait(&empty[s], (round - 1) & 1);\n        TICK(0)\n"
         "        take(u - L.NS);\n        TICK(1)\n"),
        ("      if (round > 0) store(u - L.NS);\n",
         "      TICK(2)\n      if (round > 0) store(u - L.NS);\n      TICK(1)\n"),
        ("    mbar_wait(&full[s], (u / L.NS) & 1);  // unit u has landed\n",
         "    TICK(5)\n    mbar_wait(&full[s], (u / L.NS) & 1);\n    TICK(0)\n"),
        ("    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage\n",
         "    if (lane == 0) mbar_arrive(&empty[s]);\n    TICK(1)\n"),
        ("    mbar_wait(&turn[warp], (u / NG) & 1);\n",
         "    TICK(2)\n    mbar_wait(&turn[warp], (u / NG) & 1);\n    TICK(3)\n"),
        ("    if (lane == 0) mbar_arrive(&turn[(warp + 1) % W]);\n",
         "    if (lane == 0) mbar_arrive(&turn[(warp + 1) % W]);\n    TICK(4)\n"),
        ('extern "C" {\n\n// Bytes of dynamic shared memory',
         'extern "C" {\nint native_score_probe_clocks(unsigned long long* out, int clear) {\n'
         "  unsigned long long z[16] = {};\n"
         "  if (clear) return (int)cudaMemcpyToSymbol(probe_clk, z, sizeof(z));\n"
         "  return (int)cudaMemcpyFromSymbol(out, probe_clk, sizeof(z));\n}\n\n"
         "// Bytes of dynamic shared memory"),
    ],
}
NATIVE_CLOCKS = {0: ("first consumer warp", ("wait for the slab", "rows", "m1 at the scan's end",
                                             "wait for the m3 turn", "m3 turn", "loop")),
                 6: ("last consumer warp", ("wait for the slab", "rows", "m1 at the scan's end",
                                            "wait for the m3 turn", "m3 turn", "loop")),
                 12: ("producer", ("wait for a free stage", "m2 sums", "copy issue", "loop"))}


def ptxas_lines(log: str, symbol: str = "native_tables_kernel") -> str:
    """ptxas's register and spill lines for the kernel named `symbol`, one
    per instantiation, led by its template arguments as mangled (`<3,8>`
    for integers, `<b1,2>` for a bool and an integer)."""
    out, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and symbol in kernel and ("registers" in line or "spill" in line):
            tmpl = kernel.split(symbol, 1)[1].split("Ev", 1)[0]
            args = ",".join(("b" if k == "b" else "") + v
                            for k, v in re.findall(r"L([bi])(\d+)E", tmpl))
            out.append(f"<{args}> {line.split(':', 1)[-1].strip()}")
    return "\n  ".join(out)


def probe_native(tmp: Path, earlier=None) -> None:
    logs = {}
    texts = {"earlier": Path(earlier).read_text()} if earlier else None
    libs = build_variants("native_score", NATIVE_VARIANTS, tmp, texts, logs)
    for dims in ((22, 31, 176), (43, 31, 351)):
        probe_native_at(libs, logs, dims)


def probe_native_at(libs: dict, logs: dict, dims) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    (X, Y, Z), C = dims, 3
    tm = score.native_templates(
        *[torch.randn((C,) + sh, generator=gen, device=dev) * 0.01
          for sh in ((X, Z), (Y, Z), (X, Y))])
    cube = (torch.rand((4096, X, Y, Z), generator=gen, device=dev) * 255).round().to(
        torch.bfloat16)
    want = score.native_tables_ref(cube, tm)
    for variant, lib in libs.items():
        score._bind(lib)

        def tables(B, lib=lib):
            t = [torch.empty(sh, dtype=torch.float32, device=dev)
                 for sh in ((B, C, Y), (B, C, X), (B, C, Z))]
            err = lib.native_score_tables(
                cube.data_ptr(), tm.t_xz.data_ptr(), tm.t_yz.data_ptr(), tm.t_xy.data_ptr(),
                *[t_.data_ptr() for t_ in t], B, X, Y, Z, C,
                torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"native_score_tables launch failed: CUDA error {err}")
            return t

        err = max(float((g - w).abs().max()) for g, w in zip(tables(4096), want))
        torch.cuda.synchronize()
        line = (f"native {variant} at {dims}: device "
                f"{device_ms(lambda: tables(4096), 'native_tables_kernel', 20):.4f} ms at B=4096, "
                f"{device_ms(lambda: tables(64), 'native_tables_kernel', 20):.4f} ms at B=64; "
                f"max |kernel - plain| {err:.3e}")
        if variant == "clocks":
            lib.native_score_probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
            out = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.native_score_probe_clocks(None, 1)
            tables(4096)
            torch.cuda.synchronize()
            lib.native_score_probe_clocks(out, 0)
            slabs = 4096 * X
            for base, (who, names) in NATIVE_CLOCKS.items():
                line += (f"; {who} clocks per slab: "
                         + ", ".join(f"{n} {out[base + k] / slabs:.0f}"
                                     for k, n in enumerate(names)))
        print(f"{line}\n  {ptxas_lines(logs[variant])}", flush=True)


# The mma probe: int8 mma.sync m16n8k32 (the table kernels' instruction) in
# a register-only loop of `chains` independent accumulators a warp, one
# block of `warps` warps on each SM.
MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int kChains>
__global__ void __launch_bounds__(512, 1) mma_rate_kernel(int iters, int* out) {
  int d[kChains][4] = {};
  const uint32_t x = threadIdx.x;
  const uint32_t a0 = x, a1 = x * 3u, a2 = x ^ 5u, a3 = 7u, b0 = x * 11u, b1 = 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 0x7fffffff) out[0] = s;  // keeps the products
}
extern "C" int mma_rate(int chains, int blocks, int warps, int iters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (chains == 1) mma_rate_kernel<1><<<blocks, 32 * warps, 0, st>>>(iters, o);
  else if (chains == 4) mma_rate_kernel<4><<<blocks, 32 * warps, 0, st>>>(iters, o);
  else mma_rate_kernel<8><<<blocks, 32 * warps, 0, st>>>(iters, o);
  return (int)cudaGetLastError();
}
"""


def probe_mma(tmp: Path) -> None:
    """int8 mma.sync m16n8k32 a warp can issue: device time of a loop on
    every SM, as TOPS and SM clocks an mma (at the SM clock nvidia-smi
    reads under the load), beside the card's 1,979 TOPS int8 peak."""
    src = tmp / "mma_rate.cu"
    src.write_text(MMA_SOURCE)
    lib_path = tmp / "libmma_rate.so"
    subprocess.run([_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    dev = torch.device("cuda", 0)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    iters = 4096
    for warps, chains in ((16, 8), (16, 4), (16, 1), (4, 8), (8, 8)):
        def run(warps=warps, chains=chains):
            err = lib.mma_rate(chains, sms, warps, iters, out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"mma_rate launch failed: CUDA error {err}")
        ms = device_ms(run, "mma_rate_kernel", 5)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
        n = sms * warps * iters * chains  # mma
        tops = n * 16 * 8 * 32 * 2 / (ms * 1e-3) / 1e12
        print(f"mma {warps} warps an SM x {chains} chains: {ms:.4f} ms, {tops:.0f} TOPS int8, "
              f"{ms * 1e-3 * float(clock or 'nan') * 1e6 / (n / sms):.2f} SM clocks an mma "
              f"(clocks.sm {clock} MHz after the run)", flush=True)


def probe_traces(n: int = 40) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z, C = 22, 31, 176, 3
    tm = score.native_templates(
        *[torch.randn((C,) + sh, generator=gen, device=dev) * 0.01
          for sh in ((X, Z), (Y, Z), (X, Y))])
    cube = (torch.rand((64, X, Y, Z), generator=gen, device=dev) * 255).to(torch.bfloat16)
    fns = {"k": lambda: score.native_tables(cube, tm)}
    fns["k"]()
    torch.cuda.synchronize()
    for reps in (1, 20):
        got = [profiling.trace_device_us(fns, {"k": "native_tables_kernel"}, reps)["k"]
               for _ in range(n)]
        lacking = sum(cnt != reps for _, cnt in got)
        print(f"traces: {reps} launches of B7 at B=64: {lacking} of {n} traces lack "
              f"records (launch counts seen: {sorted({cnt for _, cnt in got})})", flush=True)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe runs on the card only")
    earlier = None
    if "--earlier" in argv:
        i = argv.index("--earlier")
        earlier, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    which = argv or ["rbf", "i8", "tails", "native"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if "rbf" in which:
            probe_rbf(Path(tmp))
        if "i8" in which:
            probe_i8(Path(tmp), earlier)
        if "tails" in which:
            probe_tails(Path(tmp))
        if "batches" in which:
            probe_batches(Path(tmp), earlier)
        if "native" in which:
            probe_native(Path(tmp), earlier)
        if "mma" in which:
            probe_mma(Path(tmp))
    if "traces" in which:
        probe_traces()


if __name__ == "__main__":
    main(sys.argv[1:])
