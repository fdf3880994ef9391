"""Device meshes: the counterpart of `caffeonspark_tpu/parallel/mesh.py`.

A `Mesh` places ranks on torch devices along the named axes (pp, ep,
sp, tp, dp), as a JAX Mesh places them on jax devices.  Several ranks
may share one device: an sp ring of 4 ranks runs on one card, as the
JAX package's CPU suite runs its rings on virtual devices that share one
CPU.  What stays per rank is the arithmetic and the choreography; only
the transport between ranks (`parallel.sp.ppermute`) is a copy between
devices, a no-op between ranks of one device.

Only the sp axis runs a program of its own so far (the ring attention
of `parallel/sp.py`).  Data parallelism, tp, ep and pp wait for the
data-parallel slice (ROADMAP Queue 1 item 6): `build_mesh`, which every
mesh comes from, refuses any axis but sp > 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXES = ("pp", "ep", "sp", "tp", "dp")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'dp[,tp[,sp[,ep]]]' → build_mesh kwargs; rejects extra dims
    instead of silently dropping them.  Any token may instead be a
    named 'axis=N' dim ('pp=4', 'tp=2,pp=2', '2,2,pp=2') — the only
    spelling for the pp axis, which has no positional slot.  The same
    grammar and messages as the JAX package's parser."""
    names = ["dp", "tp", "sp", "ep"]
    out: Dict[str, int] = {}
    pos = 0
    for tok in spec.split(","):
        tok = tok.strip()
        if "=" in tok:
            name, _, val = tok.partition("=")
            name = name.strip()
            if name not in AXES:
                raise ValueError(
                    f"mesh spec {spec!r}: unknown axis {name!r} "
                    f"(axes: {','.join(AXES)})")
            dim = int(val)
        else:
            if pos >= len(names):
                raise ValueError(
                    f"mesh spec {spec!r} has more than {len(names)} "
                    f"positional dims ({','.join(names)})")
            name = names[pos]
            pos += 1
            dim = int(tok)
        if name in out:
            raise ValueError(
                f"mesh spec {spec!r}: axis {name!r} given twice")
        if dim < 1:
            raise ValueError(
                f"mesh spec {spec!r}: axis {name!r} must be >= 1, "
                f"got {dim}")
        out[name] = dim
    return out


class Mesh:
    """Ranks laid out on the axes (pp, ep, sp, tp, dp): `devices` is the
    numpy object array of shape (pp, ep, sp, tp, dp) whose entry is the
    torch.device of that rank; `shape` maps each axis name to its
    extent, in AXES order."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"mesh devices need {len(AXES)} axes "
                             f"{AXES}, got shape {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices of the ranks along `axis_name`, at index 0 of
        every other axis: the ranks of one ring."""
        i = AXES.index(axis_name)
        index = [0] * len(AXES)
        out = []
        for r in range(self.devices.shape[i]):
            index[i] = r
            out.append(self.devices[tuple(index)])
        return out

    def describe(self) -> Dict[str, object]:
        """JSON-serializable summary with the JAX package's
        `MeshLayout.describe` keys: axes with extent > 1, the number of
        ranks, and the sharded blobs (none: every parameter is
        replicated)."""
        axes = {ax: int(n) for ax, n in self.shape.items() if n > 1}
        return {"axes": axes or {"dp": 1}, "devices": self.size,
                "sharded_params": []}


def build_mesh(*, dp: Optional[int] = None, tp: int = 1, sp: int = 1,
               pp: int = 1, ep: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over `devices` (one rank each, in order; a device may repeat)
    with named axes (pp, ep, sp, tp, dp); dp is inferred as the
    remainder when unset.  The default is one rank per visible card.
    Only sp may exceed 1 so far."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise ValueError("no CUDA device visible: pass the ranks' "
                             "devices (e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    fixed = tp * sp * pp * ep
    if n % fixed != 0:
        raise ValueError(
            f"{n} devices not divisible by tp*sp*pp*ep={fixed}")
    if dp is None:
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError(f"dp*tp*sp*pp*ep={dp * fixed} != {n} devices")
    later = {a: d for a, d in (("dp", dp), ("tp", tp), ("ep", ep),
                               ("pp", pp)) if d > 1}
    if later:
        raise ValueError(
            f"mesh {later}: the PyTorch port runs the sp axis so far; dp, "
            "tp, ep and pp > 1 wait for its data-parallel slice (ROADMAP "
            "Queue 1 item 6)")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(pp, ep, sp, tp, dp))

