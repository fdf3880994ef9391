"""Parameters and solver state across packages.

`params_from_numpy` takes parameters as numpy arrays, keyed
`{layer: {blob: ndarray}}` the way the JAX package keys its params, and
returns the port's tensors on the net's device.  It checks them against
the net's layout first: a missing layer, a missing blob or a shape
mismatch raises, where `checkpoint.copy_layers` (finetune semantics)
would skip it.  `opt_state_from_numpy` / `opt_state_to_numpy` do the
same for the solver's (iter, history, history2), so both packages'
solvers can start from one state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .net import Net, Params
from .solver import OptState

NumpyParams = Dict[str, Dict[str, np.ndarray]]


def params_from_numpy(net: Net,
                      arrays: Dict[str, Dict[str, np.ndarray]]) -> Params:
    out: Params = {}
    for lname, specs in net.param_layout.items():
        if lname not in arrays:
            raise KeyError(f"layer {lname!r} missing from the given "
                           f"params (have {sorted(arrays)})")
        blobs = arrays[lname]
        out[lname] = {}
        for bname, shape, _ in specs:
            if bname not in blobs:
                raise KeyError(f"{lname}/{bname} missing from the given "
                               f"params (have {sorted(blobs)})")
            arr = np.asarray(blobs[bname])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{lname}/{bname}: shape "
                                 f"{tuple(arr.shape)} != {tuple(shape)}")
            # np.array copies, so the result never aliases the caller's
            # (possibly read-only) buffer
            out[lname][bname] = torch.from_numpy(np.array(arr)).to(
                dtype=net.dtype, device=net.device)
    return out


def params_to_numpy(params: Params) -> NumpyParams:
    return {ln: {bn: t.detach().to("cpu").numpy().copy()
                 for bn, t in bl.items()} for ln, bl in params.items()}


def opt_state_from_numpy(net: Net, it: int, history: NumpyParams,
                         history2: NumpyParams) -> OptState:
    """(iter, history, history2) as numpy -> the port's OptState on the
    net's device, checked against the net's layout."""
    return OptState(iter=int(it), history=params_from_numpy(net, history),
                    history2=params_from_numpy(net, history2))


def opt_state_to_numpy(state: OptState
                       ) -> Tuple[int, NumpyParams, NumpyParams]:
    return (int(state.iter), params_to_numpy(state.history),
            params_to_numpy(state.history2))
