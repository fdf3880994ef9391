"""Eager training-step times of the PyTorch port on one CUDA card, to
compare checkouts of this repository in one session on one card.

    python3 scripts/torch_eager_ab.py ROOT_A ROOT_B [--steps N] [--rounds R]
                                      [--paths P [P ...]]

Each ROOT is a checkout (its `chip_smoke.py` and
`caffeonspark_tpu_torch/`).  The roots run in the order A, B, B, A,
`--rounds` times over, each in a process of its own that builds the
root's kernels and times, with the root's own `chip_smoke` helpers,
`--steps` synchronized direct steps (`chip_smoke.direct_steps`, after 3
warm-up steps) of each of `--paths` at its chip_smoke shape, float32
with no mesh: by default the two host-bound paths, lstm_lm (LRCN
widths, B 32, T 20) and the transformer LM (16 x 64, T 2048, B 4); also
`googlenet_fused_f32` (bvlc_googlenet, B 32, crop 224, with
COS_FUSE_BIAS_RELU_LRN=1: K3 + K4 on norm2) and `alexnet_fused_f32`
(AlexNet, B 256, crop 227, the same knob: K3 + K4 on norm1 and norm2),
both on a 256-record seeded LMDB.  With `--device-busy`, each path
also gets 3 steps under torch.profiler (`chip_smoke.profile_train_step`)
whose device-busy ms land under "<path> device_busy".  The last line of
the output
is one JSON object: each run's median, minimum and step times, by root
and path, and each root's median of its runs' medians.  With one ROOT
the script times that root in this process and prints its JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys


PATHS = ("lstm_lm_f32", "transformer_lm_f32", "googlenet_fused_f32",
         "alexnet_fused_f32")
FUSED = {"COS_FUSE_BIAS_RELU_LRN": "1"}


def solver_configs(cs, workdir: str, paths) -> dict:
    """{path: (solver prototxt, knobs)}, written with the root's own
    chip_smoke helpers."""
    out = {}
    if "lstm_lm_f32" in paths:
        out["lstm_lm_f32"] = (cs.write_lstm_config(workdir)[0], {})
    if "transformer_lm_f32" in paths:
        out["transformer_lm_f32"] = (cs.write_lm_config(workdir), {})
    if {"googlenet_fused_f32", "alexnet_fused_f32"} & set(paths):
        from caffeonspark_tpu_torch.models import zoo
        lmdb = cs.write_train_data(workdir, n=cs.TRAIN_B)
        if "googlenet_fused_f32" in paths:
            out["googlenet_fused_f32"] = (cs.write_zoo_config(
                workdir, zoo.googlenet, lmdb, cs.GOOGLENET_SOLVER, seed=3,
                xavier_convs=True)[0], FUSED)
        if "alexnet_fused_f32" in paths:
            out["alexnet_fused_f32"] = (cs.write_train_config(
                workdir, zoo.alexnet, lmdb, seed=2), FUSED)
    return out


def time_root(root: str, steps: int, paths=PATHS[:2],
              device_busy: bool = False) -> dict:
    """{path: [ms of each step]} of `root`, measured in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from caffeonspark_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        raise SystemExit("torch_eager_ab: no CUDA device visible")
    cuda_build.build_all()
    workdir = os.path.join(root, "build", "eager_ab")
    os.makedirs(workdir, exist_ok=True)
    out = {}
    for name, (solver_path, env) in solver_configs(cs, workdir,
                                                   paths).items():
        with cs.env_set(env):
            solver, host = cs.make_solver(torch, solver_path, env, "cuda")
            params, state = solver.init()
            cs.direct_steps(torch, solver, params, state, host, n=3)
            out[name] = cs.direct_steps(torch, solver, params, state, host,
                                        n=steps)
            if device_busy:
                profiles = [cs.profile_train_step(torch, name, solver, params,
                                                  state, host)
                            for _ in range(3)]
                out[f"{name} device_busy"] = [
                    p["device_busy_us"] / 1e3 for p in profiles if p]
        del solver, params, state, host
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--paths", nargs="+", choices=PATHS,
                    default=list(PATHS[:2]))
    ap.add_argument("--device-busy", action="store_true")
    args = ap.parse_args(argv)
    if len(args.roots) == 1:
        print(json.dumps(time_root(args.roots[0], args.steps, args.paths,
                                   args.device_busy)), flush=True)
        return 0
    order = (list(args.roots) + list(reversed(args.roots))) * args.rounds
    runs = []
    for root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--steps",
             str(args.steps), "--paths", *args.paths,
             *(["--device-busy"] if args.device_busy else [])],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root,
                     "median_ms": {k: statistics.median(v)
                                   for k, v in ms.items()},
                     "min_ms": {k: min(v) for k, v in ms.items()},
                     "ms": ms})
        print(f"{root}: " + ", ".join(
            f"{k} median {v:.3f} ms"
            for k, v in runs[-1]["median_ms"].items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    by_root = {root: {k: statistics.median(
        r["median_ms"][k] for r in runs if r["root"] == root)
        for k in runs[0]["median_ms"]} for root in args.roots}
    print(json.dumps({"card": smi.stdout.strip(), "steps": args.steps,
                      "rounds": args.rounds, "median_of_medians": by_root,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
