#!/usr/bin/env python3
"""Timed variants of K1, K2 and K3, the across-channel LRN forward,
backward and bias+ReLU forward of the PyTorch port
(caffeonspark_tpu_torch/csrc/lrn.cu: `cos_lrn_fwd`, `cos_lrn_bwd`,
`cos_bias_relu_lrn_fwd`), on one NVIDIA card: what holds each kernel from
its byte bound, at every shape and dtype chip_smoke.py's phase 3 times.

  plan         the kernel as the port launches it (`lrn_plan`'s tile and
               run; checked bit-equal to the plain version, K2 in bf16
               within one bf16 ulp);
  run_<r>      the same build on channel runs of r (and `run_C`: one run);
  tile_<t>     the same build on tiles of t positions (the planner's run
               for that tile);
  copy         one PyTorch copy of the same bytes (the forward's
               y.copy_(x), the backward's torch.add(x, dy, out=dx)): the
               card's memory path at this size, launch included;
  no_norm      csrc/lrn.cu with the normalizer's log / exp (and the
               backward's division) cut out: the staging and the rings
               alone;
  bf16_no_fixup
               the forward in bf16 on the lg2 / ex2 path alone, without
               the exact fixup of the y near a bf16 rounding midpoint (not
               the plain y bit for bit: the cost of that exactness);
  fwd_minblocks, bwd_minblocks
               the forward (backward) built for 1536 (1024) threads an
               SM (`__launch_bounds__`' second argument): fewer registers;
  bwd_batch_4  K2 with half a stage's normalizers before their divisions
               (K4's kBatch), not the whole stage's;
  bwd_lean     K2 computing each step's offsets in the staged rows, not
               keeping them in registers;
  bwd_stages_4 K2's ring of four stages (three in flight);
  parent       the kernels of another checkout (--parent DIR, its
               csrc/lrn.cu built the same way), on their own launch.

The edited copies are built with the port's own nvcc flags into
build/lrn_variants/; only `plan` and `parent` compute the whole of a
kernel with the port's numbers (`no_norm` exists to be timed).  Run from
the repository root on a machine with a card:

    python3 scripts/lrn_variants.py [--parent build/parent]

It prints the card's name and power limit, the registers of the staged
kernels (`-Xptxas -v`), one line a shape, and a JSON line last:
{"lrn_variants": [{"kernel", "shape", "dtype", "relu", "bound_ms",
"plan": ..., variant: ms, ...}]}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

B, TRAIN_B = 64, 256
# (kernel, shape, relu, dtypes): phase 3's timed K1 / K3 / K2 shapes
CASES = ([(1, (B, 96, 27, 27), False, "fb"), (1, (B, 256, 13, 13), False, "fb"),
          (1, (B, 96, 55, 55), True, "fb"), (1, (B, 256, 27, 27), True, "fb"),
          (3, (B, 96, 55, 55), True, "fb"), (3, (B, 256, 27, 27), True, "fb"),
          (1, (TRAIN_B, 96, 27, 27), False, "f"),
          (1, (TRAIN_B, 256, 13, 13), False, "f"),
          (3, (TRAIN_B, 96, 55, 55), True, "f"),
          (3, (TRAIN_B, 256, 27, 27), True, "f"),
          (2, (TRAIN_B, 96, 27, 27), False, "fb"),
          (2, (TRAIN_B, 256, 13, 13), False, "fb"),
          (2, (TRAIN_B, 96, 55, 55), True, "fb")])
LEAN = [
    ("""  int ox[kStage], oy[kStage];
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int lx = (int)(at_elem<T>(a.x, sample +
                                             (long long)(i_begin + s) * HW) &
                         15);
    const int ly = (int)(at_elem<T>(a.dy, sample + (long long)(i_begin + s -
                                                                PAD) * HW) &
                         15);
    ox[s] = s * RB + lx + tid * (int)sizeof(T);
    oy[s] = (kStage + s) * RB + ly + tid * (int)sizeof(T);
  }""", """  const int lx0 = (int)(at_elem<T>(a.x, sample + (long long)i_begin * HW) &
                        15);
  const int ly0 = (int)(at_elem<T>(a.dy, sample + (long long)(i_begin - PAD) *
                                                      HW) & 15);
  const int hw16 = (int)(((unsigned)HW & 15u) * sizeof(T));
  const int me = tid * (int)sizeof(T);
  auto ox = [&](int s) { return s * RB + ((lx0 + s * hw16) & 15) + me; };
  auto oy = [&](int s) {
    return (kStage + s) * RB + ((ly0 + s * hw16) & 15) + me;
  };"""),
    ("""          float xp = from_smem(sb + ox[s], T());
          if constexpr (RELU) xp = fmaxf(xp, 0.f);
          dd[b] = from_smem(sb + oy[s], T());""",
     """          float xp = from_smem(sb + ox(s), T());
          if constexpr (RELU) xp = fmaxf(xp, 0.f);
          dd[b] = from_smem(sb + oy(s), T());""")]
BATCH_4 = [("constexpr int kBatch = 8;       // backward",
            "constexpr int kBatch = 4;       // backward")]
PATCHES = {
    "no_norm": [
        ("  return __fmul_rn(x, expf(__fmul_rn(nbeta, logf(s))));",
         "  return __fmul_rn(x, s);"),
        ("  const float p = __fmul_rn(nbeta, lg2(s));\n"
         "  const float y = __fmul_rn(x, ex2(p));",
         "  const float p = 0.f;\n  const float y = __fmul_rn(x, s);"),
        ("    return {s, expf(__fmul_rn(nbeta, logf(s)))};",
         "    return {s, s};"),
        ("    u = __fdiv_rn(__fmul_rn(__fmul_rn(d, x), p.b), p.a);",
         "    u = __fmul_rn(__fmul_rn(d, x), p.b);"),
        ("    const float l = lg2(__fmaf_rn(coef, acc, k));\n"
         "    return {ex2(__fmul_rn(nbeta1, l)), ex2(__fmul_rn(nbeta, l))};",
         "    const float l = __fmaf_rn(coef, acc, k);\n"
         "    return {l, l};")],
    "bf16_no_fixup": [("            if (!sure) {", "            if (false) {")],
    "fwd_minblocks": [
        ("__global__ void __launch_bounds__(TILE) fwd(const Args a) {",
         "__global__ void __launch_bounds__(TILE, 1536 / TILE)\n"
         "fwd(const Args a) {")],
    "bwd_batch_4": BATCH_4,
    "bwd_lean": LEAN,
    "bwd_stages_4": [("constexpr int kBwdStages = 3;", "constexpr int kBwdStages = 4;")],
    "bwd_minblocks": [
        ("__global__ void __launch_bounds__(TILE) bwd(const Args a) {",
         "__global__ void __launch_bounds__(TILE, 1024 / TILE)\n"
         "bwd(const Args a) {")],
}
ALPHA, BETA, KK, LS = 1e-4, 0.75, 1.0, 5
NAMES = {1: "lrn_across_channels", 2: "lrn_across_channels_bwd",
         3: "bias_relu_lrn_across_channels"}


def declare_parent(lib):
    """The first design's entry points (no plan; +beta)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cos_lrn_fwd.argtypes = [P, P, I, I, I, I, F, F, F, I, I, P]
    lib.cos_bias_relu_lrn_fwd.argtypes = [P, P, P, I, I, I, I, F, F, F, I,
                                          P]
    lib.cos_lrn_bwd.argtypes = [P, P, P, I, I, I, I, F, F, F, F, I, I, P]
    for fn in (lib.cos_lrn_fwd, lib.cos_bias_relu_lrn_fwd, lib.cos_lrn_bwd):
        fn.restype = I
    return lib


def build(cuda_build, parent):
    """{variant: library} of the edited copies (and the parent's), built
    at once; the port's own library is cuda_build.library("lrn")."""
    from pathlib import Path
    src = (cuda_build.CSRC / "lrn.cu").read_text()
    out = Path(REPO) / "build" / "lrn_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs, libs = {}, {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"lrn_variants: {name}: the source no "
                                 f"longer holds {old!r}")
            text = text.replace(old, new)
        path = out / f"lrn_{name}.cu"
        path.write_text(text)
        jobs[path] = libs[name] = out / f"liblrn_{name}.so"
    if parent:
        path = out / "lrn_parent.cu"
        path.write_text((Path(parent) / "caffeonspark_tpu_torch" / "csrc" /
                         "lrn.cu").read_text())
        jobs[path] = libs["parent"] = out / "liblrn_parent.so"
    outputs = cuda_build._compile(jobs, verbose=True)
    import chip_smoke as S
    for path, text in outputs.items():
        for r in S.ptxas_report(text, lambda k: "6staged3bwd" in k):
            if "128, 2, false" in r["kernel"]:
                print(f"  ptxas {path.stem}: {r['kernel'][:60]}: "
                      f"{r['registers']} registers, spills "
                      f"{r.get('spill_stores')}/{r.get('spill_loads')}",
                      flush=True)
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        loaded[name] = (declare_parent(lib) if name == "parent"
                        else cuda_build._declare("lrn", lib))
    return loaded


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("lrn_variants: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as S
    from caffeonspark_tpu_torch.ops import cuda_build
    from caffeonspark_tpu_torch.ops import kernels as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--kernels", default="123",
                    help="which of K1, K2, K3 to time (default all)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "lrn_variants.json"))
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    report = cuda_build.build_all(verbose=True)
    for r in S.ptxas_report(report["nvcc"].get("lrn", ""),
                            lambda k: "6staged" in k):
        if ", 2, " in r["kernel"] or "_wide" in r["kernel"]:
            print(f"  ptxas {r['kernel'][:100]}: {r['registers']} registers,"
                  f" spills {r.get('spill_stores')}/{r.get('spill_loads')}",
                  flush=True)
    libs = build(cuda_build, args.parent)
    own = cuda_build.library("lrn")
    stream = torch.cuda.current_stream().cuda_stream
    sms = K._sm_count(0)
    records = []
    for kernel, shape, relu, dtypes in CASES:
        if str(kernel) not in args.kernels:
            continue
        for dtype in [{"f": torch.float32, "b": torch.bfloat16}[d]
                      for d in dtypes]:
            rec = one_case(S, K, torch, own, libs, stream, sms, kernel,
                           shape, relu, dtype)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi.stdout.strip(), "lrn_variants": records}, f)
    print(json.dumps({"lrn_variants": records}))
    return 0


def one_case(S, K, torch, own, libs, stream, sms, kernel, shape, relu,
             dtype):
    name = NAMES[kernel]
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"{name}{shape}{dtype}{relu}".encode()))
    x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=g)
    n, c, hw = shape[0], shape[1], shape[2] * shape[3]
    code = K._LRN_DTYPES[dtype]
    esize = x.element_size()
    nbytes = (3 if kernel == 2 else 2) * x.numel() * esize
    sets = [(x.clone(), dy.clone(), b.clone())
            for _ in range(S.rotations(nbytes))]
    occ = tuple(own.cos_lrn_occupancy(kernel, LS, t, code, int(relu))
                for t in K.LRN_TILES)
    plan = K.lrn_plan(shape, LS, sms, occ, kernel)

    def launcher(lib, tile, run):
        def go(x, dy, b):
            out = torch.empty_like(x)
            if kernel == 1:
                st = lib.cos_lrn_fwd(x.data_ptr(), out.data_ptr(), n, c, hw,
                                     LS, ALPHA / LS, -BETA, KK, int(relu),
                                     tile, run, code, stream)
            elif kernel == 3:
                st = lib.cos_bias_relu_lrn_fwd(
                    x.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, hw,
                    LS, ALPHA / LS, -BETA, KK, tile, run, code, stream)
            else:
                st = lib.cos_lrn_bwd(
                    x.data_ptr(), dy.data_ptr(), out.data_ptr(), n, c, hw,
                    LS, ALPHA / LS, -BETA, -BETA - 1.0, KK,
                    2.0 * ALPHA * BETA / LS, int(relu), tile, run, code,
                    stream)
            S.check(st == 0, f"{name} {shape} tile {tile} run {run}: "
                             f"cudaError {st}")
            return out
        return go

    def parent(x, dy, b):
        out = torch.empty_like(x)
        lib = libs["parent"]
        if kernel == 1:
            st = lib.cos_lrn_fwd(x.data_ptr(), out.data_ptr(), n, c, hw, LS,
                                 ALPHA / LS, BETA, KK, int(relu), code,
                                 stream)
        elif kernel == 3:
            st = lib.cos_bias_relu_lrn_fwd(x.data_ptr(), b.data_ptr(),
                                           out.data_ptr(), n, c, hw, LS,
                                           ALPHA / LS, BETA, KK, code, stream)
        else:
            st = lib.cos_lrn_bwd(x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                                 n, c, hw, LS, ALPHA / LS, BETA, KK,
                                 2.0 * ALPHA * BETA / LS, int(relu), code,
                                 stream)
        S.check(st == 0, f"parent {name} {shape}: cudaError {st}")
        return out

    if kernel == 2:
        want = K.lrn_bwd_plain(x, dy, LS, ALPHA, BETA, KK, relu)
    else:
        want = K.lrn_plain(x, LS, ALPHA, BETA, KK, relu,
                           bias=b if kernel == 3 else None)
    got = launcher(own, plan.tile, plan.run)(x, dy, b)
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    if kernel != 2 or dtype == torch.float32:
        S.check(exact, f"{name} {shape} {dtype}: not bit-equal to the plain "
                       f"version (max abs err {err:.3g})")
    t_bytes = nbytes / S.HBM_BYTES_PER_S
    rec = dict(kernel=name, shape=list(shape),
               dtype=str(dtype).replace("torch.", ""), relu=relu,
               bound_ms=1e3 * t_bytes, bit_equal=exact, max_abs_err=err,
               plan=plan._asdict(), occupancy=list(occ))
    rec["plan_ms"] = S.time_ms(launcher(own, plan.tile, plan.run), sets)[0]
    for run in sorted({8, 16, 24, 32, 48, c} - {plan.run}):
        if run <= c:
            rec[f"run_{'C' if run == c else run}_ms"] = S.time_ms(
                launcher(own, plan.tile, run), sets)[0]
    for tile in K.LRN_TILES:
        if tile != plan.tile:
            alt = K._cut_runs(name, shape, -(-hw // tile),
                              sms * occ[K.LRN_TILES.index(tile)],
                              lambda r: -(-(r + 2 * (2 if kernel == 2 else 1)
                                            * (LS // 2)) // 8) * 8)[0]
            rec[f"tile_{tile}_ms"] = S.time_ms(launcher(own, tile, alt),
                                               sets)[0]
    if kernel == 2:
        copy = lambda x, dy, b: torch.add(x, dy)  # noqa: E731
    else:
        copy = lambda x, dy, b: torch.empty_like(x).copy_(x)  # noqa: E731
    rec["copy_ms"] = S.time_ms(copy, sets)[0]
    variants = ["no_norm"]
    if kernel != 2:
        variants.append("fwd_minblocks")
        if dtype == torch.bfloat16:
            variants.append("bf16_no_fixup")
    else:
        variants += ["bwd_batch_4", "bwd_minblocks", "bwd_lean",
                     "bwd_stages_4"]
    for v in variants:
        rec[f"{v}_ms"] = S.time_ms(launcher(libs[v], plan.tile, plan.run),
                                   sets)[0]
    if "parent" in libs:
        rec["parent_ms"] = S.time_ms(parent, sets)[0]
    rec["share_of_bound"] = rec["bound_ms"] / rec["plan_ms"]
    return rec


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
