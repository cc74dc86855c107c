"""Where K1 f32's time goes on the card, at small()'s shapes.

    python3 k1_f32_cost.py [--out chiprun_out]

Needs one CUDA card and nvcc.  Builds, into unirenderer_tpu_torch/_build/
probe/ (git-ignored), copies of csrc/groupnorm.cu (the cooperative kernel,
whose f32 instance takes the f32 shapes no cluster holds) and of
csrc/groupnorm_f32.cu (the cluster kernel) with one change each, and times
them with chip_smoke.py's timer (CUDA events after an L2 flush and a spin
kernel):

  * the cooperative kernel as it is; with its grid barrier replaced by a
    block barrier (cooperative launch kept); launched as a plain kernel
    too; and without the merge that re-reads every block's partials after
    the barrier.  The differences split its fixed cost: barrier,
    cooperative launch, re-read.  The variants without the barrier give
    wrong outputs and are timed only;
  * both kernels with per-block stamps (thread 0: clock64 and %globaltimer
    at each phase boundary, after a block barrier): each phase's cycles,
    the kernel's span from its first block's start to its last block's
    end, and the timed call's remainder (launch and block scheduling);
  * the cluster kernel as it is and with the least cluster that holds the
    slice (no spreading over the SMs), against the cooperative kernel and
    one library call (`F.group_norm` + `F.silu`, TF32 off), at every
    distinct (batch, HW, C, G) of small()'s K1 signatures (chip_smoke.py
    `f32_cases`), each checked against the plain version;
  * the host time of a wrapper call (cluster route, cooperative route) and
    of the cooperative route's workspace allocation alone.

Prints one line per measurement and writes k1_f32_cost.json to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import (
    F32_GN_REL, HBM_BYTES_PER_S, Timer, f32_cases, max_sm_clock_hz,
    nvidia_smi,
)

STAMPS = 8                       # stamp slots a block
SPLIT_SHAPES = (((16, 16, 16, 128), 8), ((8, 64, 64, 32), 8),
                ((16, 64, 64, 64), 8), ((2, 64, 64, 320), 32))

STAMP_DEFS = r'''
__device__ long long g_stamp_clk[1 << 16];
__device__ long long g_stamp_ns[1 << 16];
#define STAMP(k)                                                         \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      long long t_;                                                      \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \
      g_stamp_ns[blockIdx.x * 8 + (k)] = t_;                             \
      g_stamp_clk[blockIdx.x * 8 + (k)] = clock64();                     \
    }                                                                    \
  } while (0)
extern "C" int probe_read_stamps(long long* clk, long long* ns, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_stamp_clk, n * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_stamp_ns, n * 8);
  return (int)e;
}
'''


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"probe edit: {old!r} not in the source")
        src = src.replace(old, new, 1)
    return src


def variants(csrc: Path) -> dict:
    """name -> (source text, entry point)."""
    coop = (csrc / "groupnorm.cu").read_text()
    cluster = (csrc / "groupnorm_f32.cu").read_text()
    no_sync = [("cg::this_grid().sync();", "__syncthreads();")]
    plain = no_sync + [("cudaLaunchCooperativeKernel(", "cudaLaunchKernel(")]
    no_reread = plain + [("for (int g0 = 0; g0 < groups; g0 += per_round)",
                          "for (int g0 = groups; g0 < groups; "
                          "g0 += per_round)")]
    coop_stamped = [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + STAMP_DEFS),
        ("(void)x_ext, (void)x_off, (void)part_ext, (void)cache_ext;\n",
         "(void)x_ext, (void)x_off, (void)part_ext, (void)cache_ext;\n"
         "  STAMP(0);\n"),
        ("  // ---- 2. merge the row lanes", "  STAMP(1);\n"
         "  // ---- 2. merge the row lanes"),
        ("  // ---- 4. every block's partials written",
         "  STAMP(2);\n  // ---- 4. every block's partials written"),
        ("  cg::this_grid().sync();\n",
         "  cg::this_grid().sync();\n  STAMP(3);\n"),
        ("  // ---- 6. apply:", "  STAMP(4);\n  // ---- 6. apply:"),
        ("    yb[(size_t)r * pitch + vc] = raw;\n  }\n}\n",
         "    yb[(size_t)r * pitch + vc] = raw;\n  }\n  STAMP(5);\n}\n"),
    ]
    cluster_stamped = [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + STAMP_DEFS),
        ("  // ---- 1. the CTA's rows", "  STAMP(0);\n"
         "  // ---- 1. the CTA's rows"),
        ("  // ---- 2. each column's", "  STAMP(1);\n"
         "  // ---- 2. each column's"),
        ("  // ---- 3. channels -> groups", "  STAMP(2);\n"
         "  // ---- 3. channels -> groups"),
        ("  // ---- 4. every rank's partials stored", "  STAMP(3);\n"
         "  // ---- 4. every rank's partials stored"),
        ("  // ---- 5. merge the ranks", "  STAMP(4);\n"
         "  // ---- 5. merge the ranks"),
        ("  // ---- 6. apply from", "  STAMP(5);\n  // ---- 6. apply from"),
        ("    yb[(size_t)r * nv + vc] = raw;\n  }\n}\n",
         "    yb[(size_t)r * nv + vc] = raw;\n  }\n  STAMP(6);\n}\n"),
    ]
    least = [("for (int n = least; n <= kMaxCtas; n *= 2) {",
              "for (int n = least; n <= least; n *= 2) {")]
    rows_per_lane = {k: [("constexpr int kRowsPerLane = 4;",
                          f"constexpr int kRowsPerLane = {k};")]
                     for k in (2, 8)}
    return {
        "coop": (coop, "gn_silu_forward_f32"),
        "coop_no_grid_sync": (_edit(coop, no_sync), "gn_silu_forward_f32"),
        "coop_plain_launch": (_edit(coop, plain), "gn_silu_forward_f32"),
        "coop_no_reread": (_edit(coop, no_reread), "gn_silu_forward_f32"),
        "coop_stamped": (_edit(coop, coop_stamped), "gn_silu_forward_f32"),
        "cluster": (cluster, "gn_cluster_forward_f32"),
        "cluster_least": (_edit(cluster, least), "gn_cluster_forward_f32"),
        "cluster_rows2": (_edit(cluster, rows_per_lane[2]),
                          "gn_cluster_forward_f32"),
        "cluster_rows8": (_edit(cluster, rows_per_lane[8]),
                          "gn_cluster_forward_f32"),
        "cluster_stamped": (_edit(cluster, cluster_stamped),
                            "gn_cluster_forward_f32"),
    }


def build_all(found: dict) -> dict:
    """One nvcc per variant, all started together -> name -> CDLL."""
    from unirenderer_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _) in found.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-I{_build.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs, failed = {}, []
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log[-3000:]}")
            continue
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {name}: " + " | ".join(regs[-4:]), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        entry = getattr(lib, found[name][1])
        if name.startswith("coop"):
            entry.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i,
                              i, p]
            lib.gn_max_blocks.restype = i
        else:
            entry.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i,
                              p]
            lib.gn_cluster_plan.argtypes = [i, i, i, i, i, p]
        entry.restype = i
    return libs


class Caller:
    """fn() launching one variant on fixed inputs."""

    def __init__(self, torch, lib, name, entry, x, scale, groups):
        self.torch, self.lib, self.name = torch, lib, name
        self.entry = getattr(lib, entry)
        self.x, self.scale, self.groups = x, scale, groups
        self.y = torch.empty_like(x)
        self.ws = (torch.empty(lib.gn_max_blocks() * groups * 8,
                               dtype=torch.uint8, device="cuda")
                   if name.startswith("coop") else None)
        self.batch, self.c = x.shape[0], x.shape[-1]
        self.hw = x.numel() // (self.batch * self.c)

    def __call__(self):
        t, x, s = self.torch, self.x, self.scale
        stream = t.cuda.current_stream().cuda_stream
        args = [x.data_ptr(), s.data_ptr(), s.data_ptr(), self.y.data_ptr()]
        if self.ws is not None:
            args.append(self.ws.data_ptr())
        rc = self.entry(*args, self.batch, self.hw, self.c, self.groups,
                        1e-5, 1, 0, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return self.y


def inputs(torch, shape, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 2.0 + 0.5
    scale = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
    return x, scale


def stamps(torch, lib, call, blocks, phases):
    """Per-phase cycles (median and max over blocks), the kernel's span in
    us (first start to last end, %globaltimer) and the clock it implies."""
    call()
    torch.cuda.synchronize()
    n = blocks * STAMPS
    clk = (ctypes.c_longlong * n)()
    ns = (ctypes.c_longlong * n)()
    rc = lib.probe_read_stamps(clk, ns, n)
    if rc != 0:
        raise RuntimeError(f"reading stamps: CUDA error {rc}")
    per = []
    for k in range(phases):
        d = [clk[b * STAMPS + k + 1] - clk[b * STAMPS + k]
             for b in range(blocks)]
        per.append(dict(median_cycles=statistics.median(d),
                        max_cycles=max(d)))
    start = min(ns[b * STAMPS] for b in range(blocks))
    end = max(ns[b * STAMPS + phases] for b in range(blocks))
    return dict(phases=per, span_us=(end - start) / 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k1_f32_cost: no CUDA device", file=sys.stderr)
        return 2
    from unirenderer_tpu_torch.ops import _build
    from unirenderer_tpu_torch.ops import groupnorm as gn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    found = variants(_build.CSRC_DIR)
    t = time.perf_counter()
    libs = build_all(found)
    print(f"built {len(libs)} variants in {time.perf_counter() - t:.1f} s",
          flush=True)
    timer = Timer(torch)
    record = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  sm_clock_max_hz=max_sm_clock_hz(), split=[], shapes=[])

    # ---- the cooperative kernel's fixed cost, and both kernels' phases
    for shape, groups in SPLIT_SHAPES:
        x, scale = inputs(torch, shape)
        row = dict(shape=list(shape), groups=groups)
        for name in ("coop", "coop_no_grid_sync", "coop_plain_launch",
                     "coop_no_reread", "cluster"):
            call = Caller(torch, libs[name], name, found[name][1], x, scale,
                          groups)
            try:
                row[name + "_ms"] = timer(call)
            except RuntimeError as e:        # the cluster plan refuses
                row[name + "_ms"] = None
                row[name + "_error"] = str(e)
        st = gn.plan(shape, groups, torch.float32, torch.float32)
        hw = x.numel() // (shape[0] * shape[-1])
        coop_plan = (ctypes.c_int * 5)()
        gn._lib().gn_plan(shape[0], hw, shape[-1], groups, 1, 0,
                          ctypes.addressof(coop_plan))
        call = Caller(torch, libs["coop_stamped"], "coop_stamped",
                      found["coop_stamped"][1], x, scale, groups)
        row["coop_stamped_ms"] = timer(call)
        row["coop_stamps"] = stamps(torch, libs["coop_stamped"], call,
                                    coop_plan[1], 5)
        if st["branch"] == "cluster":
            call = Caller(torch, libs["cluster_stamped"], "cluster_stamped",
                          found["cluster_stamped"][1], x, scale, groups)
            row["cluster_stamped_ms"] = timer(call)
            row["cluster_stamps"] = stamps(torch, libs["cluster_stamped"],
                                           call, st["blocks"], 6)
        row["coop_blocks"], row["plan"] = coop_plan[1], st
        row["bound_ms"] = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        record["split"].append(row)
        print("split " + json.dumps(row), flush=True)
        del x, call

    # ---- every distinct small() f32 signature: cluster (as is, least)
    # against the cooperative kernel and the library
    keys = sorted({(s[0], s[1] * s[2], s[3], g)
                   for (s, g, _, _), p in f32_cases()["gn"]
                   if p == "float32" and len(s) == 4 and s[1] <= 64
                   and s[3] <= 1024})
    for batch, hw, c, groups in keys:
        shape = (batch, hw, 1, c)
        st = gn.plan(shape, groups, torch.float32, torch.float32)
        if st["branch"] != "cluster":
            continue
        x, scale = inputs(torch, shape, seed=hw + c)
        want = gn.groupnorm_silu_reference(x, scale, scale, groups, 1e-5,
                                           True)
        tol = F32_GN_REL * want.abs().max().item()
        row = dict(shape=[batch, hw, c], groups=groups,
                   bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3)
        for name in ("cluster", "cluster_least", "cluster_rows2",
                     "cluster_rows8", "coop"):
            call = Caller(torch, libs[name], name, found[name][1], x, scale,
                          groups)
            try:
                err = (call() - want).abs().max().item()
            except RuntimeError as e:        # this variant's plan refuses
                row[name + "_ms"], row[name + "_error"] = None, str(e)
                continue
            torch.cuda.synchronize()
            row[name + "_ok"] = err <= tol
            row[name + "_ms"] = timer(call)
        xc = x.permute(0, 3, 1, 2)
        row["library_ms"] = timer(
            lambda: F.silu(F.group_norm(xc, groups, scale, scale, 1e-5)))
        row["plan"] = st
        record["shapes"].append(row)
        print("shape " + json.dumps(row), flush=True)
        del x, want, call

    # ---- host time a call: the wrapper on each route, the workspace
    host = {}
    for label, shape, groups in (("cluster route", (2, 16, 16, 128), 16),
                                 ("cooperative route", (2, 64, 64, 320),
                                  32)):
        x, scale = inputs(torch, shape)
        for _ in range(20):
            gn.fused_groupnorm_silu(x, scale, scale, groups, 1e-5, True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            gn.fused_groupnorm_silu(x, scale, scale, groups, 1e-5, True)
        host[label] = (time.perf_counter() - t) / 200 * 1e6
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        torch.empty(gn._max_blocks(0) * 32 * 8, dtype=torch.uint8,
                    device="cuda")
    host["workspace alone"] = (time.perf_counter() - t) / 200 * 1e6
    record["host_us"] = host
    print("host_us " + json.dumps(host), flush=True)
    bad = [r["shape"] for r in record["shapes"]
           if not all(r[k] for k in r if k.endswith("_ok"))]
    record["out_of_tolerance"] = bad
    os.makedirs(args.out, exist_ok=True)
    Path(args.out, "k1_f32_cost.json").write_text(json.dumps(record,
                                                             indent=1))
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"out of tolerance: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
