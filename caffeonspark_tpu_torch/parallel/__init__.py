"""Parallelism of the PyTorch port (the counterpart of
`caffeonspark_tpu/parallel/`): device meshes and their layouts
(`mesh.py`), the transport between ranks (`comm.py`), the gradient
exchange (`gradsync.py`), the data- and tensor-parallel step with ZeRO-1
(`dp.py`) and the sequence-parallel ring attention (`sp.py`).  The JAX
package's exports that the port has; its pipeline and sync modes are
later slices."""

from .mesh import (MeshLayout, build_mesh, dp_data_rank, lockstep_steps,
                   parse_mesh_spec, tp_param_specs)
from .sp import attention, ring_attention, sp_shard_time

__all__ = ["MeshLayout", "ParallelSolver", "attention", "build_mesh",
           "dp_data_rank", "lockstep_steps", "parse_mesh_spec",
           "ring_attention", "sp_shard_time", "tp_param_specs",
           "zero_state_specs"]


def __getattr__(name):
    # dp.py imports the solver, whose layers import comm.py from this
    # package: dp loads on first use, so the layers can import comm
    if name in ("ParallelSolver", "zero_state_specs"):
        from . import dp
        return getattr(dp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
