"""Measure the correlation-statistics kernel (K2), for A/B runs on one card.

    python3 tools/torch_corr_stats_ab.py [--root DIR] [--ks 3,4,10,16]
        [--kernel] [--paths] [--sass] [--cuts] [--repeats 5]

Imports ``probabilit_tpu_torch`` from ``--root`` (default: this
repository), so one call on the card can measure two checkouts in turns
(parent, change, change, parent: unpack the parent with ``git archive``
into a directory that ``.gitignore`` lists).  The package never imports
this script.  Prints one JSON object per line, the card's ``nvidia-smi``
name and power limit first.  Needs a CUDA card, ``nvcc`` and
``cuobjdump``.

``--kernel``: for each K of ``--ks``, ``cuda_exec.corr_stats`` on
columns 3 j + 1 at n = 1e8 from sample 0 and on one 2^24 block at
``start`` = 2^24 (CUDA events, median of ``--repeats`` after a warm-up),
with the grid, whether a repeat gives the same sums bitwise, and the
median SM clock and power ``nvidia-smi`` reads over 300 launches.

``--paths``: ``sample(1e8, executor="cuda")`` (CUDA events) and
``estimate(1e9)`` (host clock around a call that ends in a host read) of
``mixed_correlated_50`` and ``table_risk_correlated``; K1 alone at 1e8
on ``mixed_dag_20`` and ``mixed_correlated_50``.

``--sass``: builds the checkout's ``csrc/corr_stats.cu`` (ptxas's
registers and spill bytes per K) and counts the SASS of each instance
(``cuobjdump -sass``; ``--dump DIR`` writes it there): the opcodes of its
sample loop (the loop around the most Philox multiplies and tensor-core
products), with the loop's conditional regions (a forward
branch over them: the partial-tile masks, the Giles tail under its vote,
the float64 flush) counted apart, and the loop's instructions per
sample.

``--cuts``: builds cut-down copies of the checkout's kernel (text
substitutions on a copy of ``csrc/`` under the build directory) and
times them at n = 1e8 for each K of ``--ks`` beside the whole kernel.
For a kernel that sums in registers (the design before the tensor
cores): ``sum_z_only`` (draws and scores, no cross products),
``sum_z_only_central`` (the same without the Giles tail) and
``sum_u_only`` (draws only: the uniforms summed).  For the tensor-core
kernel: ``no_mma`` (draws, scores, the TF32 split and the tile stores;
no fragment loads or products), and what was tried beside the design:
``no_vote`` (the tail for every score, as before), ``one_vote_per_call``
(one vote for a call's four words), ``bunched`` (a tile's products all
after its last Philox call instead of spread over the calls) and
``min_blocks_4`` (a register budget for four blocks an SM up to K = 4).  ``none`` is the kernel as it
is, timed the same way.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N = 100_000_000
N_STREAM = 1_000_000_000
BLOCK = 1 << 24


def emit(obj):
    print(json.dumps(obj), flush=True)


def tensor_core_kernel(source):
    return "mma.sync" in source


def sass_functions(cuobjdump, library):
    """{function name: [(address, opcode, text)]} of a library's SASS."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    functions, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            functions[name] = []
            continue
        instr = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if name and instr:
            text = instr.group(2).strip()
            body = re.sub(r"^@!?U?P[T0-9]\s+", "", text)
            functions[name].append((int(instr.group(1), 16), body.split()[0], text))
    return functions


def opcode_class(opcode):
    """The opcode with the modifiers that matter for counting."""
    parts = opcode.split(".")
    if parts[0] in ("IMAD", "MUFU", "HMMA", "F2F", "LDS", "STS") and len(parts) > 1:
        return ".".join(parts[:2])
    return parts[0]


def branch_target(text):
    found = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+,\s*)?(?:`\()?(0x[0-9a-f]+)", text)
    return int(found.group(1), 16) if found else None


def loop_profile(instrs):
    """The sample loop of one kernel instance (see below); forward-branched
    regions inside it counted apart."""
    # Code after the first EXIT is the divergent paths of warp votes, which
    # branch back into the loop: no loop of its own.
    exits = [addr for addr, opcode, _ in instrs if opcode == "EXIT"]
    last = min(exits) if exits else float("inf")
    branches = [(addr, branch_target(text), text) for addr, _, text in instrs
                if branch_target(text) is not None and addr < last]
    back = [(target, addr) for addr, target, _ in branches if target <= addr]
    # The sample loop: the backward branch around the most Philox
    # multiplies (by 0xD2511F53 or 0xCD9E8D57) and tensor-core products,
    # the narrowest of those (the divergent paths of a vote repeat some of
    # a call's code after the loop).
    core = [addr for addr, opcode, text in instrs
            if opcode.startswith("HMMA") or re.search(r"-0x2daee0ad|-0x326172a9", text)]
    if not back or not core:
        return None
    lo, hi = max(back, key=lambda r: (sum(r[0] <= c <= r[1] for c in core), r[0] - r[1]))
    regions = []
    for addr, target, text in branches:
        if lo <= addr < hi and addr < target <= hi and text.startswith("@"):
            regions.append((addr + 16, target))
    # Keep the outermost conditional regions only.
    regions = [r for r in regions
               if not any(o != r and o[0] <= r[0] and r[1] <= o[1] for o in regions)]

    def in_region(addr):
        return next((r for r in regions if r[0] <= addr < r[1]), None)

    always, apart = Counter(), {}
    for addr, opcode, _ in instrs:
        if not lo <= addr <= hi:
            continue
        region = in_region(addr)
        if region is None:
            always[opcode_class(opcode)] += 1
        else:
            apart.setdefault(region, Counter())[opcode_class(opcode)] += 1
    return {
        "loop": [hex(lo), hex(hi)], "unconditional": dict(always.most_common()),
        "unconditional_total": sum(always.values()),
        "conditional_regions": [
            {"range": [hex(r[0]), hex(r[1])], "instructions": sum(c.values()),
             "mufu": sum(v for op, v in c.items() if op.startswith("MUFU")),
             "dadd": c.get("DADD", 0), "opcodes": dict(c.most_common(8))}
            for r, c in apart.items()],
    }


def sass_report(torch, _build, cuda_exec, source, ks, dump):
    lib_path, log = _build.build("corr_stats")
    cuobjdump = _build.nvcc_path().parent / "cuobjdump"
    functions = sass_functions(cuobjdump, lib_path)
    if dump:
        Path(dump).mkdir(parents=True, exist_ok=True)
        (Path(dump) / "corr_stats.sass").write_text(subprocess.run(
            [str(cuobjdump), "-sass", str(lib_path)], check=True, capture_output=True,
            text=True).stdout)
    regs = {}
    for line_name, regs_spill in ptxas_registers(log).items():
        regs[line_name] = regs_spill
    tc = tensor_core_kernel(source)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in ks:
        name = next(f for f in functions if re.search(rf"corr_stats\w*?ILi{k}E", f))
        instrs = functions[name]
        profile = loop_profile(instrs)
        if tc:
            from probabilit_tpu_torch.ops import corr_tiles

            samples_per_pass = corr_tiles.samples_per_tile(k)  # a warp's pass of the loop
            per_sm = cuda_exec.stats_blocks_per_sm(k)
        else:
            mults = sum(v for op, v in profile["unconditional"].items()
                        if op in ("IMAD.WIDE", "IMAD.HI"))
            groups = max(1, round(mults / (20 * k)))  # 20 multiplies a Philox call
            samples_per_pass = 4 * groups * 32  # a warp's pass: 32 threads' groups
            per_sm = cuda_exec.stats_grid(k, 1 << 40) // sms
        total = profile["unconditional_total"]
        emit({"sass": "corr_stats", "k": k, "function_instructions": len(instrs),
              "registers_and_spill_bytes": regs.get(k), "blocks_per_sm": per_sm,
              "warps_per_sm": per_sm * 8, "samples_per_warp_pass": samples_per_pass,
              "issue_slots_per_sample": total / samples_per_pass,
              "thread_instructions_per_sample": 32 * total / samples_per_pass,
              **profile})


def ptxas_registers(log):
    """{K: [registers, spill-store bytes]} of the corr_stats instances."""
    out, k, spill = {}, None, 0
    for line in log.splitlines():
        found = re.search(r"Function properties for \S*corr_statsILi(\d+)E", line)
        if found:
            k, spill = int(found.group(1)), 0
        elif k and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif k and "Used" in line:
            out[k] = [int(re.search(r"Used (\d+) registers", line).group(1)), spill]
            k = None
    return out


CUTS = {
    False: {  # sums in registers: the design before the tensor cores
        "none": [],
        "sum_z_only": [
            ("acc[K + j * K - j * (j - 1) / 2 + (k - j)] += z[j][lane] * z[k][lane];", "")],
        "sum_z_only_central": [
            ("acc[K + j * K - j * (j - 1) / 2 + (k - j)] += z[j][lane] * z[k][lane];", ""),
            ("return (w < 5.0f ? p1 : p2) * x;", "return p1 * x;")],
        "sum_u_only": [
            ("acc[K + j * K - j * (j - 1) / 2 + (k - j)] += z[j][lane] * z[k][lane];", ""),
            ("sampling_math::ndtri_fast(sampling_math::bits_to_open_unit(bits[lane]))",
             "sampling_math::bits_to_open_unit(bits[lane])")],
    },
    True: {  # the tensor-core kernel
        "none": [],
        "no_mma": [('asm("mma.sync', 'if (false) asm("mma.sync')],
        "no_vote": [("if (__any_sync(0xFFFFFFFFu, live && w[j] >= 5.0f)) {", "if (true) {")],
        "one_vote_per_call": [(
            "if (__any_sync(0xFFFFFFFFu, live && w[j] >= 5.0f)) {",
            "if (__any_sync(0xFFFFFFFFu, live && fmaxf(fmaxf(w[0], w[1]), "
            "fmaxf(w[2], w[3])) >= 5.0f)) {")],
        "bunched": [("for (int step = c * T::kSteps / T::kCalls; step < (c + 1) * T::kSteps / T::kCalls; ++step) {",
                     "for (int step = c + 1 == T::kCalls ? 0 : T::kSteps; step < T::kSteps; ++step) {")],
        "min_blocks_4": [("kMinBlocks = K <= 8 ? 3 : 2;", "kMinBlocks = K <= 4 ? 4 : (K <= 8 ? 3 : 2);")],
    },
}


def cut_kernels(torch, _build, source, ks, repeats):
    tc = tensor_core_kernel(source)
    dtype = torch.float64 if tc else torch.float32
    words = (0x1234, 0x5678)
    originals = {rel: (_build.CSRC / rel).read_text() for rel in ("corr_stats.cu", "sampling_math.cuh")}

    def build_cut(item):
        label, subs = item
        missing = [old for old, _ in subs if not any(old in text for text in originals.values())]
        if missing:
            raise SystemExit(f"cut {label}: no {missing[0]!r} in the checkout's sources")
        copy = _build.BUILD_DIR / f"cut_{label}"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(_build.CSRC, copy)
        for rel, text in originals.items():
            for old, new in subs:
                text = text.replace(old, new)
            (copy / rel).write_text(text)
        lib_path = copy / f"corr_stats_{label}.so"
        t0 = time.perf_counter()
        log = _build._compile(copy / "corr_stats.cu", lib_path,
                              [str(_build.nvcc_path()), *_build.NVCC_FLAGS, "-I", str(copy)])
        return label, lib_path, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(CUTS[tc])) as pool:
        built = list(pool.map(build_cut, CUTS[tc].items()))
    for label, lib_path, log, build_s in built:
        lib = ctypes.CDLL(str(lib_path))
        lib.corr_stats_grid.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
        lib.corr_stats_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        for k in ks:
            # The tensor-core kernel takes the columns from host memory, the
            # kernel before it from the card.
            cols_host = (ctypes.c_int * k)(*[3 * j + 1 for j in range(k)])
            cols_card = torch.tensor(list(cols_host), dtype=torch.int32, device="cuda")
            cols_arg = ctypes.cast(cols_host, ctypes.c_void_p).value if tc else cols_card.data_ptr()
            blocks = ctypes.c_int(0)
            assert lib.corr_stats_grid(k, N, ctypes.byref(blocks)) == 0
            partials = torch.empty((blocks.value, k + k * (k + 1) // 2), dtype=dtype,
                                   device="cuda")

            def launch():
                err = lib.corr_stats_launch(cols_arg, k, words[0], words[1], 0, N,
                                            partials.data_ptr(), blocks.value,
                                            torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            emit({"cut": label, "k": k, "n": N, "blocks": blocks.value,
                  "ms": events_ms(torch, launch, repeats), "build_s": build_s,
                  "registers_and_spill_bytes": ptxas_registers(log).get(k)})


def sampled_clocks(torch, fn, launches=300):
    """The median SM clock (MHz) and power (W) ``nvidia-smi`` reads every
    20 ms while ``fn`` runs ``launches`` times back to back."""
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.2)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    finally:
        sampler.terminate()
        out = sampler.communicate()[0]
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines() if line.strip()]
    busy = rows[len(rows) // 4:] or rows  # past the sampler's start
    return {"sm_clock_mhz": statistics.median(r[0] for r in busy),
            "power_w": statistics.median(r[1] for r in busy)}


# What the tensor cores' mma.sync costs an SM sub-partition (SMSP): each
# kernel runs `iters` rounds on 8 warps a block, 4 blocks an SM (so 8
# warps an SMSP; warp w of a block runs on SMSP w % 4).  Each warp's
# round: hmma, 4 independent m16n8k8 TF32 products; ffma, 64 FFMAs (16
# chains); int, 64 integer instructions (Philox-like IMAD.WIDE and
# 3-input XOR chains); mixed, hmma then ffma in each warp; beside,
# warps 0-3 of a block ffma and warps 4-7 hmma, so every SMSP has warps
# of both; int_beside, the same with int for ffma.
PROBE_SOURCE = r"""
#include <cstdint>
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b0));
}
template <int MODE>
__global__ void __launch_bounds__(256) probe(int iters, float* out) {
  float d[4][4] = {};
  float f[16];
  uint32_t u[16];
  for (int i = 0; i < 16; ++i) f[i] = threadIdx.x * 1e-3f + i, u[i] = threadIdx.x * 77u + i;
  const uint32_t a0 = __float_as_uint(1.0f + threadIdx.x), a1 = a0 ^ 1u, b0 = a0 ^ 2u;
  const int w = threadIdx.x >> 5;
  const bool hmma = MODE == 0 || MODE == 3 || ((MODE == 4 || MODE == 5) && w >= 4);
  const bool ffma = MODE == 1 || MODE == 3 || (MODE == 4 && w < 4);
  const bool ints = MODE == 2 || (MODE == 5 && w < 4);
  for (int it = 0; it < iters; ++it) {
    if (hmma) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mma(d[k], a0, a1, b0);
    }
    if (ffma) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 16; ++i) f[i] = fmaf(f[i], 0.999f, 0.5f);
      }
    }
    if (ints) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const uint64_t m = static_cast<uint64_t>(u[i]) * 0xD2511F53u;
          u[i] = static_cast<uint32_t>(m >> 32) ^ static_cast<uint32_t>(m) ^ u[(i + 1) & 15];
        }
      }
    }
  }
  float s = 0.0f;
  for (int k = 0; k < 4; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  for (int i = 0; i < 16; ++i) s += f[i] + static_cast<float>(u[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(int mode, int blocks, int iters, float* out) {
  switch (mode) {
    case 0: probe<0><<<blocks, 256>>>(iters, out); break;
    case 1: probe<1><<<blocks, 256>>>(iters, out); break;
    case 2: probe<2><<<blocks, 256>>>(iters, out); break;
    case 3: probe<3><<<blocks, 256>>>(iters, out); break;
    case 4: probe<4><<<blocks, 256>>>(iters, out); break;
    default: probe<5><<<blocks, 256>>>(iters, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def tensor_probe(torch, _build, repeats):
    """SMSP cycles (at 1980 MHz) of each ``PROBE_SOURCE`` mode, and what one
    mma.sync m16n8k8 TF32 costs alone and beside FP32 or integer work."""
    out_dir = _build.BUILD_DIR / "tensor_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "probe.cu").write_text(PROBE_SOURCE)
    lib_path = out_dir / "probe.so"
    lib_path.unlink(missing_ok=True)
    _build._compile(out_dir / "probe.cu", lib_path,
                    [str(_build.nvcc_path()), *_build.NVCC_FLAGS])
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    rows = {}
    for mode, name in enumerate(("hmma", "ffma", "int", "mixed", "beside", "int_beside")):
        ms = events_ms(torch, lambda: lib.probe_launch(mode, blocks, iters, out.data_ptr()),
                       repeats)
        rows[name] = ms * 1e-3 * 1.98e9
    hmma = rows["hmma"] / (8 * iters * 4)  # 8 warps an SMSP, 4 products a round
    emit({"tensor_probe": {
        "smsp_cycles": rows, "cycles_per_hmma_alone": hmma,
        "cycles_per_ffma_alone": rows["ffma"] / (8 * iters * 64),
        # beside: 4 ffma warps and 4 hmma warps an SMSP; alone each half would take
        "beside_over_sum_of_halves": rows["beside"] / ((rows["ffma"] + rows["hmma"]) / 2),
        "beside_over_max_of_halves": rows["beside"] / (max(rows["ffma"], rows["hmma"]) / 2),
        "int_beside_over_sum_of_halves": rows["int_beside"] / ((rows["int"] + rows["hmma"]) / 2),
        "mixed_over_sum": rows["mixed"] / (rows["ffma"] + rows["hmma"])}})


def events_ms(torch, fn, repeats):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def wall_ms(torch, fn, repeats):
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()  # ends in a host read
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--ks", default="3,4,10,16")
    parser.add_argument("--kernel", action="store_true")
    parser.add_argument("--paths", action="store_true")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--cuts", action="store_true")
    parser.add_argument("--dump", default=None, help="write the SASS of --sass here")
    parser.add_argument("--tensor-probe", action="store_true")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    ks = [int(k) for k in args.ks.split(",")]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    import probabilit_tpu_torch
    from probabilit_tpu_torch import _build, config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models import benchmarks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    package = Path(probabilit_tpu_torch.__file__).resolve().parent
    if package.parent != root:
        raise SystemExit(f"imported {package}, not the package under {root}")
    source = (_build.CSRC / "corr_stats.cu").read_text()
    emit({"device": smi, "package": str(package), "tensor_core_kernel": tensor_core_kernel(source)})
    config.set_device("cuda")
    words = cuda_exec.seed_words(0)

    if args.tensor_probe:
        tensor_probe(torch, _build, args.repeats)
    if args.sass:
        sass_report(torch, _build, cuda_exec, source, ks, args.dump)
    if args.cuts:
        cut_kernels(torch, _build, source, ks, args.repeats)
    if args.kernel:
        for k in ks:
            columns = [3 * j + 1 for j in range(k)]
            a = cuda_exec.corr_stats(words, N, columns, "cuda")
            b = cuda_exec.corr_stats(words, N, columns, "cuda")
            clocks = sampled_clocks(torch, lambda: cuda_exec.corr_stats(words, N, columns, "cuda"))
            emit({"kernel": "corr_stats", "card": smi, "k": k, "n": N, **clocks,
                  "ms": events_ms(torch, lambda: cuda_exec.corr_stats(words, N, columns, "cuda"),
                                  args.repeats),
                  "block_ms": events_ms(torch, lambda: cuda_exec.corr_stats(
                      words, BLOCK, columns, "cuda", start=BLOCK), args.repeats),
                  "grid": cuda_exec.stats_grid(k, N), "repeat_bitwise": bool(torch.equal(a, b))})
    if args.paths:
        for name in ("mixed_dag_20", "mixed_correlated_50"):
            sink = getattr(benchmarks, name)()
            plan = _compile.get_plan(sink)
            tape = cuda_exec.lowered(plan, [sink._id], "cuda")
            ab = cuda_exec.recolor_transform(plan, words, N, "cuda") if plan.corr_vars else None
            emit({"k1": name, "card": smi, "n": N,
                  "ms": events_ms(torch, lambda: cuda_exec.run(tape, words, N, ab), args.repeats)})
        for name in ("mixed_correlated_50", "table_risk_correlated"):
            built = getattr(benchmarks, name)()
            sink = built[0] if isinstance(built, tuple) else built
            emit({"path": name, "card": smi,
                  "sample_1e8_ms": events_ms(torch, lambda: sink.sample(
                      N, random_state=0, gc_strategy=[], executor="cuda"), args.repeats),
                  "estimate_1e9_ms": wall_ms(torch, lambda: sink.estimate(
                      N_STREAM, random_state=0), min(args.repeats, 3))})


if __name__ == "__main__":
    main()
