"""Where the hand-written kernels spend their time: a probe for the card.

    python3 -m radarml_tpu_torch.utils.kernel_probe [rbf] [i8] [tails] [native] [traces] [--earlier FILE.cu]

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
i8 (the combo kernel of i8_score.cu; default arena, 6 class rows, B = 4096
and 64):
  as_committed  the kernel as it is
  loads_only    no t1 / t2 / t3 steps: the slab pipeline alone
  warps_24      24 warps a block instead of 16
  clocks        clock64 around the phases of a slab, summed over the
                blocks by warp 0 and warp 15: clocks per slab
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
native (B7; default arena, 3 random classes, B = 4096 and 64; each
variant's registers and spills as ptxas reports them, and its largest
|error| against the plain version):
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
traces: how often a profiler trace, taken as kernel_device_ms takes it,
lacks the records of a kernel that ran in it: 40 traces each of B7 at
B = 64 (one launch ~0.04 ms) with 1 and with 20 launches.
"""

from __future__ import annotations

import ctypes
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
I8_TICK = (
    "#define TICK(k) if (lane == 0 && (warp == 0 || warp == kWarps - 1)) { "
    "long long n_ = clock64(); atomicAdd(&probe_clk[(warp ? 8 : 0) + k], "
    "(unsigned long long)(n_ - t_)); t_ = n_; }\n")
I8_VARIANTS = {
    "as_committed": [],
    "loads_only": I8_SKIP,
    "warps_24": [("constexpr int kThreads = 512;", "constexpr int kThreads = 768;")],
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
        ("      set ^= 1;  // this set is next used two scans on, block barriers later\n    }\n",
         "      set ^= 1;\n    }\n    TICK(5)\n"),
        ('extern "C" {\n\n// The x-slab width',
         'extern "C" {\nint i8_score_probe_clocks(unsigned long long* out, int clear) {\n'
         "  unsigned long long z[16] = {};\n"
         "  if (clear) return (int)cudaMemcpyToSymbol(probe_clk, z, sizeof(z));\n"
         "  return (int)cudaMemcpyFromSymbol(out, probe_clk, sizeof(z));\n}\n\n"
         "// The x-slab width"),
    ],
}


def probe_i8(tmp: Path) -> None:
    libs = build_variants("i8_score", I8_VARIANTS, tmp)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z, C2 = 22, 31, 176, 6
    q = [torch.randint(-127, 128, (C2,) + sh, generator=gen, device=dev, dtype=torch.int8)
         for sh in ((X, Z), (Y, Z), (X, Y))]
    cube = torch.randint(-128, 128, (4096, X, Y, Z), generator=gen, device=dev, dtype=torch.int8)
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

        line = (f"i8 {variant}: device "
                f"{device_ms(lambda: tables(4096), 'combo_tables_kernel', 20):.4f} ms at B=4096, "
                f"{device_ms(lambda: tables(64), 'combo_tables_kernel', 20):.4f} ms at B=64")
        if variant == "clocks":
            lib.i8_score_probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
            out = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.i8_score_probe_clocks(None, 1)
            tables(4096)
            torch.cuda.synchronize()
            lib.i8_score_probe_clocks(out, 0)
            slabs = 4096 * 2  # two x-slabs a scan at this arena
            names = ("loop top", "wait for the slab", "t1/t2 steps", "t3 steps",
                     "barrier", "write-out")
            for base, who in ((0, "warp 0"), (8, "warp 15")):
                line += (f"; {who} clocks per slab: "
                         + ", ".join(f"{n} {out[base + k] / slabs:.0f}"
                                     for k, n in enumerate(names))
                         + f" (sum {sum(out[base:base + 6]) / slabs:.0f})")
        print(line, flush=True)


TAILS_VARIANTS = {
    "as_committed": [],
    "loads_only": I8_SKIP,
    # sel and sel3 read, wait at a block barrier and clear in their epilogue
    # instead of clearing each set ahead of the next scan's last slab
    "sel3_barrier": [("    cleared_ahead = ns > 1;\n", "    cleared_ahead = false;\n")],
}


def probe_tails(tmp: Path) -> None:
    libs = build_variants("i8_score", TAILS_VARIANTS, tmp)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z, C2, T = 22, 31, 176, 6, 4
    q = [torch.randint(-127, 128, (C2,) + sh, generator=gen, device=dev, dtype=torch.int8)
         for sh in ((X, Z), (Y, Z), (X, Y))]
    cube = torch.randint(-128, 128, (4096, X, Y, Z), generator=gen, device=dev, dtype=torch.int8)
    ijk = torch.stack([torch.randint(0, n, (4096, T), generator=gen, device=dev)
                       for n in (X, Y, Z)], -1).to(torch.int32)
    kidx = ijk[..., 2].contiguous()
    qp = [t_.data_ptr() for t_ in q]
    for variant, lib in libs.items():
        i8_score._bind(lib)
        stream = torch.cuda.current_stream(dev).cuda_stream
        resident = {k: getattr(lib, f"i8_score_{k}_resident")(X, Y, Z, C2, 1, 1, 1)
                    for k in ("lookup", "grouped")}
        width = lib.i8_score_slab_width(X, Y, Z, C2, 1, 1, 1)

        def combo(B, lib=lib):
            t = [torch.empty(sh, dtype=torch.int32, device=dev)
                 for sh in ((B, C2, Y), (B, C2, X), (B, Z, C2))]
            err = lib.i8_score_onepass_tables(cube.data_ptr(), *qp, *[t_.data_ptr() for t_ in t],
                                              B, X, Y, Z, C2, stream)
            if err != 0:
                raise RuntimeError(f"i8_score_onepass_tables launch failed: CUDA error {err}")
            return t

        def lookup(B, plan=None, kernel="lookup", lib=lib):
            P, XS = plan or i8_tails.lookup_plan(B, X, resident[kernel], width)
            t = [torch.empty(sh, dtype=torch.int32, device=dev)
                 for sh in ((B, C2, Y), (B, C2, X), (B, Z, C2))]
            err = getattr(lib, f"i8_score_{kernel}_tables")(
                cube.data_ptr(), *qp, *[t_.data_ptr() for t_ in t], B, X, Y, Z, C2, XS, P,
                stream)
            if err != 0:
                raise RuntimeError(f"i8_score_{kernel}_tables launch failed: CUDA error {err}")
            return t

        def grouped(B):
            return lookup(B, kernel="grouped")

        def sel(B, lib=lib):
            t = [torch.empty(sh, dtype=torch.int32, device=dev)
                 for sh in ((B, C2, Y), (B, C2, X), (B, T, C2))]
            err = lib.i8_score_sel_tables(cube.data_ptr(), *qp, kidx.data_ptr(),
                                          *[t_.data_ptr() for t_ in t], B, X, Y, Z, C2, T,
                                          stream)
            if err != 0:
                raise RuntimeError(f"i8_score_sel_tables launch failed: CUDA error {err}")
            return t

        def sel3(B, lib=lib):
            s = [torch.empty((B, T, C2), dtype=torch.int32, device=dev) for _ in range(3)]
            err = lib.i8_score_sel3_scores(cube.data_ptr(), *qp, ijk.data_ptr(), None,
                                           *[s_.data_ptr() for s_ in s], B, X, Y, Z, C2, T,
                                           stream)
            if err != 0:
                raise RuntimeError(f"i8_score_sel3_scores launch failed: CUDA error {err}")
            return s

        parts = []
        for name, fn, symbol in (("combo", combo, "combo_tables_kernel"),
                                 ("lookup", lookup, "lookup_tables_kernel"),
                                 ("grouped", grouped, "grouped_tables_kernel"),
                                 ("sel", sel, "sel_tables_kernel"),
                                 ("sel3", sel3, "sel3_scores_kernel")):
            parts.append(f"{name} " + " / ".join(
                f"{device_ms(lambda B=B, fn=fn: fn(B), symbol, 20):.4f}" for B in (4096, 64)))
        line = (f"tails {variant}: device ms at B=4096 / 64: " + ", ".join(parts)
                + f" (resident blocks {resident}, slab width {width})")
        if variant == "as_committed":
            sweep = []
            for B in (1, 7, 100, 131, 132, 133):
                P, XS = i8_tails.lookup_plan(B, X, resident["lookup"], width)
                sweep.append(f"B={B} (P {P}, XS {XS}) "
                             f"{device_ms(lambda B=B: lookup(B), 'lookup_tables_kernel', 20):.4f}"
                             f" / glookup "
                             f"{device_ms(lambda B=B: grouped(B), 'grouped_tables_kernel', 20):.4f}")
            for B, plan in ((64, (3, 8)), (100, (1, width)), (131, (1, width))):
                if not all(torch.equal(a, b) for a, b in zip(lookup(B, plan), lookup(B))):
                    raise AssertionError(f"lookup tables at B={B} differ under the plan {plan}")
                ms = device_ms(lambda B=B, plan=plan: lookup(B, plan), "lookup_tables_kernel", 20)
                sweep.append(f"B={B} forced (P {plan[0]}, XS {plan[1]}) {ms:.4f}")
            line += "; lookup " + ", ".join(sweep)
        print(line, flush=True)


_NATIVE_LOADS_ONLY = [("        if (y < Y)\n          row_step<C>(",
                       "        if (y < Y && B < 0)\n          row_step<C>(")]
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


def ptxas_lines(log: str) -> str:
    """ptxas's register and spill lines for the table kernel, one per
    instantiation, shortened to `C, W: registers, spills`."""
    out, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and "native_tables_kernel" in kernel and (
                "registers" in line or "spill" in line):
            tmpl = kernel.split("ILi")[1:] if "ILi" in kernel else [kernel]
            args = ",".join(t.split("E")[0] for t in tmpl)
            out.append(f"<{args}> {line.split(':', 1)[-1].strip()}")
    return "\n  ".join(out)


def probe_native(tmp: Path, earlier=None) -> None:
    logs = {}
    texts = {"earlier": Path(earlier).read_text()} if earlier else None
    libs = build_variants("native_score", NATIVE_VARIANTS, tmp, texts, logs)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X, Y, Z, C = 22, 31, 176, 3
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
        line = (f"native {variant}: device "
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
            probe_i8(Path(tmp))
        if "tails" in which:
            probe_tails(Path(tmp))
        if "native" in which:
            probe_native(Path(tmp), earlier)
    if "traces" in which:
        probe_traces()


if __name__ == "__main__":
    main(sys.argv[1:])
