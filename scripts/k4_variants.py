#!/usr/bin/env python3
"""Timed variants of K4, the fused bias+ReLU+LRN backward of the PyTorch
port (caffeonspark_tpu_torch/csrc/lrn.cu, `cos_bias_relu_lrn_bwd`), on one
NVIDIA card: what holds the kernel from its byte bound.

Each variant but the first two is csrc/lrn.cu with one part of K4 cut
out or changed, built with the port's own nvcc flags
(`cuda_build.build_variants`) into build/k4_variants/; all are timed at
AlexNet's norm1 / norm2 (B 256) and GoogLeNet's norm2 (B 32), f32 and
bf16, on the launch plan the port would use for it:

  as_built       the kernel as the port builds and launches it;
  dx_only        the port's build with d_bias's sums left out (its C entry
                 point called without the partial-sum buffer);
  compute_only   without the copies (the steps read stale shared memory);
  copies_only    without the steps (no dx is written);
  exact_bf16     bf16 with f32's arithmetic (precise logf / expf, IEEE
                 division);
  no_l2_line     16-byte copies without the L2's 128-byte line fetch;
  batch_1        each step's normalizer taken alone (kBatch 1: its log,
                 exp and division before the next step's);
  batch_8        a whole stage's normalizers taken together (kBatch 8);
  stages_2       a ring of two stages (one in flight), less shared memory;
  run_x2, run_x4, run_half
                 the port's build on channel runs 2x, 4x or 1/2 as long as
                 `k4_plan`'s (fewer halo steps, fewer blocks; or more).

Only `as_built` computes the whole of K4 (`dx_only` its dx, the
batch variants all of it); the others exist to be timed.  Run from the
repository root on a machine with a card:

    python3 scripts/k4_variants.py

It prints the card's name and power limit, one line a shape, and a JSON
line last: {"k4_variants": {shape/dtype: {variant: ms}}, "bound_ms": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [(256, 96, 55, 55), (256, 256, 27, 27), (32, 192, 56, 56)]
PATCHES = {
    "compute_only": [
        ("    if (st + kStages - 1 < n_st) issue(st + kStages - 1);", ""),
        ("    if (st < n_st) issue(st);", "")],
    "copies_only": [
        ("    const unsigned char* sb = &rows[st % kStages][0][0];",
         "    if (n_st > 0) continue;\n"
         "    const unsigned char* sb = &rows[st % kStages][0][0];")],
    "exact_bf16": [("Norm<sizeof(T) == 4>", "Norm<true>")],
    "no_l2_line": [("cp.async.cg.shared.global.L2::128B",
                    "cp.async.cg.shared.global")],
    "batch_1": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "batch_8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "stages_2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}
RUN_SCALES = {"run_x2": 2.0, "run_x4": 4.0, "run_half": 0.5}


def build(cuda_build):
    """{variant: (library, with d_bias, run scale)}: the port's own
    library (as built, dx only, on rescaled runs), then the edited
    copies, all built at once."""
    src = (cuda_build.CSRC / "lrn.cu").read_text()
    sources = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"k4_variants: {name}: the source no longer "
                                 f"holds {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    own = cuda_build.library("lrn")
    built = cuda_build.build_variants(
        "lrn", sources, os.path.join(REPO, "build", "k4_variants"))
    return {"as_built": (own, True, 1.0), "dx_only": (own, False, 1.0),
            **{name: (own, True, f) for name, f in RUN_SCALES.items()},
            **{name: (lib, True, 1.0) for name, lib in built.items()}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device visible", file=sys.stderr)
        return 2
    from caffeonspark_tpu_torch.ops import cuda_build
    from caffeonspark_tpu_torch.ops import kernels as K
    from chip_smoke import HBM_BYTES_PER_S, rotations, time_ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build(cuda_build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alpha, beta, k, ls = 1e-4, 0.75, 1.0, 5
    stream = torch.cuda.current_stream().cuda_stream
    result, bounds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        code = K._LRN_DTYPES[dtype]
        for shape in SHAPES:
            n, c, h, w = shape
            gen = torch.Generator(device="cuda").manual_seed(sum(shape))
            x = (torch.randn(shape, device="cuda", generator=gen) * 3
                 ).to(dtype)
            dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            b = torch.randn(c, device="cuda", generator=gen)
            nbytes = 3 * x.numel() * x.element_size() + 8 * c
            sets = [(x.clone(), dy.clone()) for _ in range(rotations(nbytes))]
            key = f"{shape} {str(dtype).replace('torch.', '')}"
            bounds[key] = 1e3 * nbytes / HBM_BYTES_PER_S
            result[key] = {}
            for name, (lib, with_db, scale) in libs.items():
                plan = K.k4_plan(shape, ls, sms,
                                 lib.cos_bias_relu_lrn_bwd_occupancy(
                                     ls, code, int(with_db)))
                run = max(1, min(c, int(plan.run * scale)))
                dx = torch.empty_like(x)
                part = torch.empty((c, n * plan.tiles), device="cuda")
                db = torch.empty(c, device="cuda")
                part_p, db_p = ((part.data_ptr(), db.data_ptr()) if with_db
                                else (None, None))

                def launch(xs, dys, lib=lib, plan=plan, run=run, dx=dx,
                           part_p=part_p, db_p=db_p):
                    status = lib.cos_bias_relu_lrn_bwd(
                        xs.data_ptr(), b.data_ptr(), dys.data_ptr(),
                        dx.data_ptr(), part_p, db_p, n, c, h * w, ls,
                        alpha / ls, -beta, -beta - 1.0, k,
                        2.0 * alpha * beta / ls, plan.tiles, run, code,
                        stream)
                    if status:
                        raise RuntimeError(f"k4_variants: cudaError {status}")
                result[key][name] = time_ms(launch, sets, iters=30)[0]
            del sets
            print(f"{key}: bound {bounds[key]:.4f} ms; " + ", ".join(
                f"{v} {ms:.4f} ms ({bounds[key] / ms:.3f})"
                for v, ms in result[key].items()), flush=True)
    print(json.dumps({"k4_variants": result, "bound_ms": bounds,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
