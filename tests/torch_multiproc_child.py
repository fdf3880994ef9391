"""One process of the port's multi-process tests (tests/test_torch_
multiproc*.py), started by them with `subprocess`; it imports neither
jax nor the JAX package.

    python torch_multiproc_child.py steps SPEC.json
        ParallelSolver steps over this process's dp ranks: SPEC names
        the rendezvous, the net and solver texts, the params and global
        batches (npz files), and where to write the losses, the exchange
        mode, comm_info and the final params.
    python torch_multiproc_child.py mesh SPEC.json
        ParallelSolver steps on a global mesh (SPEC["dims"]) of which
        this process holds its box: each process feeds the block of
        every global batch at its dp coordinates (`dp_data_rank`, on
        each input's batch axis); writes the losses, the final params
        gathered whole, this process's bytes of the split blobs and of
        their state, and the bytes each axis sent across processes.
    python torch_multiproc_child.py ring SPEC.json
        `parallel.sp.ring_attention` over an sp axis of SPEC["sp"] ranks
        spanning the processes, on the whole q, k, v of SPEC["qkv"]:
        the output and the gradients of q, k and v of sum(out * g).
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
    ps = ParallelSolver(s, build_mesh(devices=[cpu] * k),
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


def mesh_steps(spec_path: str) -> int:
    from caffeonspark_tpu_torch import convert
    from caffeonspark_tpu_torch.ops.layers import flash_mesh
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    from caffeonspark_tpu_torch.parallel import comm
    from caffeonspark_tpu_torch.parallel.mesh import (distributed_init,
                                                      dp_data_rank)
    from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
    from caffeonspark_tpu_torch.solver import Solver

    with open(spec_path) as f:
        spec = json.load(f)
    procs, rank = distributed_init(spec["server"], spec["procs"],
                                   spec["rank"])
    dims = spec["dims"]
    local = int(np.prod(list(dims.values()))) // procs
    s = Solver(SolverParameter.from_text(spec["solver"]),
               NetParameter.from_text(spec["net"]), device="cpu")
    with np.load(spec["params"]) as z:
        params = {}
        for key in z.files:
            ln, bn = key.split("/")
            params.setdefault(ln, {})[bn] = torch.from_numpy(np.array(z[key]))
    mesh = build_mesh(devices=[torch.device("cpu")] * local, **dims)
    ps = ParallelSolver(s, mesh)
    params = ps.shard_params(params)
    st = ps.shard_opt_state(s.init_state(params))
    ps.check_start(params, st)
    split_bytes = sum(params[ln][bn].numel() * 4 for ln, bn in ps.split)
    state_bytes = sum(st.history[ln][bn].numel() * 4
                      for ln, bn in ps.split)
    block, blocks = dp_data_rank(mesh)
    axes = s.train_net.input_batch_axes()
    with np.load(spec["batches"]) as z:
        names = sorted({key.split("/")[1] for key in z.files})
        n = len({key.split("/")[0] for key in z.files})
        batches = [{name: np.array(z[f"{i}/{name}"]) for name in names}
                   for i in range(n)]
    comm.reset_traffic()
    losses = []
    for b in batches:
        feed = {}
        for name, v in b.items():
            ax = axes.get(name, 0)
            feed[name] = torch.from_numpy(np.ascontiguousarray(
                np.split(v, blocks, axis=ax)[block]))
        with flash_mesh(mesh):
            loss, _ = ps.train_step(params, st, feed)
        losses.append(float(loss))
    traffic = dict(comm.TRAFFIC)
    whole = ps.gather_params(params)
    out = {f"param/{ln}/{bn}": a for ln, bl in
           convert.params_to_numpy(whole).items() for bn, a in bl.items()}
    np.savez(f"{spec['out']}.rank{rank}.npz", losses=np.asarray(losses),
             split_bytes=np.asarray(split_bytes),
             state_bytes=np.asarray(state_bytes),
             traffic=np.asarray(json.dumps(traffic)), **out)
    return 0


def ring(spec_path: str) -> int:
    from caffeonspark_tpu_torch.parallel import build_mesh
    from caffeonspark_tpu_torch.parallel.mesh import distributed_init
    from caffeonspark_tpu_torch.parallel.sp import ring_attention

    with open(spec_path) as f:
        spec = json.load(f)
    procs, rank = distributed_init(spec["server"], spec["procs"],
                                   spec["rank"])
    sp = int(spec["sp"])
    mesh = build_mesh(sp=sp, devices=[torch.device("cpu")] * (sp // procs))
    with np.load(spec["qkv"]) as z:
        q, k, v, g = (torch.from_numpy(np.array(z[n])).requires_grad_(n != "g")
                      for n in ("q", "k", "v", "g"))
    out = ring_attention(q, k, v, mesh, causal=bool(spec["causal"]),
                         flash=bool(spec["flash"]))
    torch.sum(out * g).backward()
    np.savez(f"{spec['out']}.rank{rank}.npz", out=out.detach().numpy(),
             dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
    return 0


def main(argv) -> int:
    from caffeonspark_tpu_torch.parallel.mesh import distributed_close
    torch.set_num_threads(1)
    modes = {"steps": steps, "mesh": mesh_steps, "ring": ring}
    if argv[0] in modes:
        rc = modes[argv[0]](argv[1])
        distributed_close()
        return rc
    if argv[0] == "mini_cluster":
        from caffeonspark_tpu_torch import mini_cluster
        return mini_cluster.main(argv[1:])
    raise SystemExit(f"unknown mode {argv[0]!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
