"""Eager training-step times of the PyTorch port on one CUDA card, to
compare checkouts of this repository in one session on one card.

    python3 scripts/torch_eager_ab.py ROOT_A ROOT_B [--steps N] [--rounds R]

Each ROOT is a checkout (its `chip_smoke.py` and
`caffeonspark_tpu_torch/`).  The roots run in the order A, B, B, A,
`--rounds` times over, each in a process of its own that builds the
root's kernels and times, with the root's own `chip_smoke` helpers,
`--steps` synchronized direct steps (`chip_smoke.direct_steps`, after 3
warm-up steps) of two host-bound paths at their chip_smoke shapes:
lstm_lm (LRCN widths, B 32, T 20) and the transformer LM (16 x 64,
T 2048, B 4), both float32 with no mesh.  The last line of the output
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


def time_root(root: str, steps: int) -> dict:
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
    paths = {"lstm_lm_f32": cs.write_lstm_config(workdir)[0],
             "transformer_lm_f32": cs.write_lm_config(workdir)}
    out = {}
    for name, solver_path in paths.items():
        solver, host = cs.make_solver(torch, solver_path, {}, "cuda")
        params, state = solver.init()
        cs.direct_steps(torch, solver, params, state, host, n=3)
        out[name] = cs.direct_steps(torch, solver, params, state, host,
                                    n=steps)
        del solver, params, state, host
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if len(args.roots) == 1:
        print(json.dumps(time_root(args.roots[0], args.steps)), flush=True)
        return 0
    order = (list(args.roots) + list(reversed(args.roots))) * args.rounds
    runs = []
    for root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--steps",
             str(args.steps)], capture_output=True, text=True, timeout=900)
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
