"""One process of the port's multi-process tests (tests/test_torch_
multiproc*.py), started by them with `subprocess`; it imports neither
jax nor the JAX package.

    python torch_multiproc_child.py steps SPEC.json
        ParallelSolver steps over this process's dp ranks: SPEC names
        the rendezvous, the net and solver texts, the params and global
        batches (npz files), and where to write the losses, the exchange
        mode, comm_info and the final params.
    python torch_multiproc_child.py mini_cluster ARGS...
        `caffeonspark_tpu_torch.mini_cluster.main(ARGS)`.

Each child runs torch on one thread.
"""

import json
import sys

import numpy as np
import torch


def steps(spec_path: str) -> int:
    from caffeonspark_tpu_torch import convert
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    from caffeonspark_tpu_torch.parallel.mesh import distributed_init
    from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
    from caffeonspark_tpu_torch.solver import Solver

    with open(spec_path) as f:
        spec = json.load(f)
    procs, rank = distributed_init(spec["server"], spec["procs"],
                                   spec["rank"])
    cpu = torch.device("cpu")
    s = Solver(SolverParameter.from_text(spec["solver"]),
               NetParameter.from_text(spec["net"]), device="cpu")
    with np.load(spec["params"]) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    params = {}
    for key, a in arrays.items():
        ln, bn = key.split("/")
        params.setdefault(ln, {})[bn] = torch.from_numpy(a)
    k = int(spec["k"])
    ps = ParallelSolver(s, build_mesh(dp=k, devices=[cpu] * k),
                        zero_dp=spec.get("zero", False))
    params = ps.shard_params(params)
    st = ps.shard_opt_state(s.init_state(params))
    ps.check_start(params, st)
    with np.load(spec["batches"]) as z:
        names = sorted({key.split("/")[1] for key in z.files})
        n = len({key.split("/")[0] for key in z.files})
        batches = [{name: np.array(z[f"{i}/{name}"]) for name in names}
                   for i in range(n)]
    losses = []
    for b in batches:
        block = {}
        for name, v in b.items():
            size = v.shape[0] // procs
            block[name] = torch.from_numpy(v[rank * size:(rank + 1) * size])
        loss, _ = ps.train_step(params, st, block)
        losses.append(float(loss))
    out = {f"param/{ln}/{bn}": a for ln, bl in
           convert.params_to_numpy(params).items() for bn, a in bl.items()}
    np.savez(f"{spec['out']}.rank{rank}.npz", losses=np.asarray(losses),
             mode=np.asarray(s.grad_sync.mode),
             comm=np.asarray(json.dumps(
                 s.grad_sync.plan.comm_info(procs))), **out)
    return 0


def main(argv) -> int:
    torch.set_num_threads(1)
    if argv[0] == "steps":
        return steps(argv[1])
    if argv[0] == "mini_cluster":
        from caffeonspark_tpu_torch import mini_cluster
        return mini_cluster.main(argv[1:])
    raise SystemExit(f"unknown mode {argv[0]!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
