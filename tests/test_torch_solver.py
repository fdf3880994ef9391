"""The PyTorch port's solver against the JAX package's: the 7 learning-
rate policies, the 6 update rules with clipping and L1/L2 decay, and
3-step LeNet trajectories through `Solver.train_step_fn`.

Both solvers start from the same parameters and optimizer state
(carried across with `convert`), and see the same batches, made with
numpy from a seed.  Tolerances: learning rates and single updates rtol
1e-6 (both compute in float32; pow/exp/sqrt may differ in the last
bit), updates with atol 1e-7, a few float32 ulps of the largest
parameters, for elements where w - update nearly cancels; trajectories
rtol 1e-4 / atol 1e-6 on each step's loss and on the final parameters
(convolutions sum in other orders on each side).  AdaGrad, RMSProp and
Adam scale a step by g / (sqrt(h) + delta), which turns a gradient near
0, whose last bits differ between the frameworks, into a step of up to
the full learning rate; their trajectories use delta 1e-3 so that such
elements stay within the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import OptState as JaxOptState
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu.solver import learning_rate as jax_learning_rate
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver, learning_rate
from torch_common import cap_torch_threads

cap_torch_threads()

POLICIES = {
    "fixed": "",
    "step": "stepsize: 3 gamma: 0.5",
    "exp": "gamma: 0.93",
    "inv": "gamma: 0.0001 power: 0.75",
    "multistep": "stepvalue: 2 stepvalue: 5 gamma: 0.3",
    "poly": "power: 2.0 max_iter: 12",
    "sigmoid": "gamma: -0.4 stepsize: 6",
}
TYPES = {
    "SGD": "base_lr: 0.01 momentum: 0.9",
    "Nesterov": "base_lr: 0.01 momentum: 0.9",
    "AdaGrad": "base_lr: 0.01 delta: 1e-6",
    "RMSProp": "base_lr: 0.001 rms_decay: 0.98 delta: 1e-6",
    "AdaDelta": "base_lr: 1.0 momentum: 0.95 delta: 1e-6",
    "Adam": "base_lr: 0.001 momentum: 0.9 momentum2: 0.999 delta: 1e-8",
}
BATCH = 4


def _solvers(text: str, batch: int = BATCH):
    """The same LeNet and solver prototxt in both packages."""
    net_text = jax_zoo.lenet(batch).to_text()
    jsolver = JaxSolver(JaxSolverParameter.from_text(text),
                        jax_zoo.lenet(batch))
    tsolver = Solver(SolverParameter.from_text(text),
                     NetParameter.from_text(net_text), device="cpu")
    return jsolver, tsolver


def _rand_params(layout, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return {ln: {bn: (rng.randn(*shape) * scale).astype(np.float32)
                 for bn, shape, _ in specs}
            for ln, specs in layout.items()}


def _jax_tree(arrays):
    return {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
            for ln, bl in arrays.items()}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_learning_rate_matches_jax(policy):
    text = (f'base_lr: 0.05 lr_policy: "{policy}" max_iter: 20 '
            + POLICIES[policy])
    sp_j = JaxSolverParameter.from_text(text)
    sp_t = SolverParameter.from_text(text)
    for it in (0, 1, 2, 3, 5, 6, 7, 11, 12, 19, 40):
        want = float(jax_learning_rate(sp_j, jnp.asarray(it, jnp.int32)))
        got = learning_rate(sp_t, it)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=f"{policy} at iter {it}")


@pytest.mark.parametrize("variant", ["l2", "l1", "clip"])
@pytest.mark.parametrize("stype", sorted(TYPES))
def test_apply_update_matches_jax(stype, variant):
    """One update from the same params, grads and non-zero histories at
    iteration 4, with L2 or L1 decay, or with clipping that engages."""
    text = (f'type: "{stype}" {TYPES[stype]} weight_decay: 0.01 '
            'iter_size: 2')
    if variant == "l1":
        text += ' regularization_type: "L1"'
    if variant == "clip":
        text += " clip_gradients: 0.5"
    jsolver, tsolver = _solvers(text)
    layout = tsolver.train_net.param_layout
    params = _rand_params(layout, 1)
    grads = _rand_params(layout, 2, scale=0.05)
    hist = {ln: {bn: np.abs(a) for bn, a in bl.items()}
            for ln, bl in _rand_params(layout, 3, 0.01).items()}
    hist2 = {ln: {bn: np.abs(a) for bn, a in bl.items()}
             for ln, bl in _rand_params(layout, 4, 0.01).items()}
    lr = np.float32(0.05)

    jp, jst = jax.jit(jsolver._apply_update)(
        _jax_tree(params), _jax_tree(grads),
        JaxOptState(iter=jnp.asarray(4, jnp.int32),
                    history=_jax_tree(hist), history2=_jax_tree(hist2)),
        jnp.asarray(lr))

    net = tsolver.train_net
    tp = convert.params_from_numpy(net, params)
    tst = convert.opt_state_from_numpy(net, 4, hist, hist2)
    tsolver.apply_update(tp, convert.params_from_numpy(net, grads), tst,
                         torch.tensor(lr))
    assert tst.iter == 5 == int(jst.iter)
    for ln, bl in tp.items():
        for bn, w in bl.items():
            for got, want in ((w, jp[ln][bn]),
                              (tst.history[ln][bn], jst.history[ln][bn]),
                              (tst.history2[ln][bn],
                               jst.history2[ln][bn])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{ln}/{bn}")


TRAJECTORIES = (
    [(f"sgd-{p}", f'type: "SGD" {TYPES["SGD"]} lr_policy: "{p}" '
      f'{POLICIES[p]}') for p in sorted(POLICIES)]
    + [(t.lower(), f'type: "{t}" {TYPES[t]}'
        + (" delta: 1e-3" if t in ("AdaGrad", "RMSProp", "Adam") else ""))
       for t in sorted(TYPES) if t != "SGD"]
    + [("sgd-iter_size2", f'{TYPES["SGD"]} iter_size: 2'),
       ("sgd-clip", f'{TYPES["SGD"]} clip_gradients: 0.05'),
       ("sgd-l1", f'{TYPES["SGD"]} regularization_type: "L1"')])


@pytest.mark.parametrize("name,text", TRAJECTORIES,
                         ids=[n for n, _ in TRAJECTORIES])
def test_lenet_trajectory_matches_jax(name, text):
    """3 steps of the port's solver against the JAX train_step_fn on the
    same LeNet params, state and batches: per-step loss and final
    params."""
    text += " weight_decay: 0.0005 max_iter: 12"
    jsolver, tsolver = _solvers(text)
    arrays = convert.params_to_numpy(tsolver.train_net.init(5))
    jp = _jax_tree(arrays)
    jst = jsolver.init_state(jp)
    jstep = jax.jit(jsolver.train_step_fn())
    tp = convert.params_from_numpy(tsolver.train_net, arrays)
    tst = tsolver.init_state(tp)
    rng = np.random.RandomState(6)
    for it in range(3):
        data = rng.rand(BATCH, 1, 28, 28).astype(np.float32)
        label = rng.randint(0, 10, BATCH).astype(np.float32)
        jp, jst, jout = jstep(jp, jst, {"data": jnp.asarray(data),
                                        "label": jnp.asarray(label)},
                              jsolver.step_rng(it))
        loss, out = tsolver.train_step(tp, tst, {
            "data": torch.from_numpy(data),
            "label": torch.from_numpy(label)})
        np.testing.assert_allclose(float(loss), float(jout["loss"]),
                                   rtol=1e-4, err_msg=f"step {it}")
        np.testing.assert_allclose(float(out["lr"]), float(jout["lr"]),
                                   rtol=1e-6)
    assert tst.iter == int(jst.iter) == 3
    for ln, bl in tp.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jp[ln][bn]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{ln}/{bn}")


def test_solver_seeds_eval_step_and_rejects_unknown_type():
    _, tsolver = _solvers('base_lr: 0.01 random_seed: 7')
    assert tsolver.init_seed == 7
    # the eval step is the serving forward over the TEST net's outputs
    rng = np.random.RandomState(1)
    feed = {"data": torch.from_numpy(rng.rand(BATCH, 1, 28, 28)
                                     .astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 10, BATCH)
                                      .astype(np.float32))}
    p, _ = tsolver.init()
    out = tsolver.eval_step_fn()(p, feed)
    assert set(out) == {"accuracy", "loss"}
    assert torch.equal(out["loss"], tsolver.test_net(p, feed)["loss"])
    _, default = _solvers('base_lr: 0.01')
    assert default.init_seed == 1701      # Caffe's clock seed, fixed
    a = convert.params_to_numpy(tsolver.init()[0])
    b = convert.params_to_numpy(tsolver.init()[0])
    assert all(np.array_equal(a[ln][bn], b[ln][bn])
               for ln in a for bn in a[ln])
    with pytest.raises(ValueError, match="solver type"):
        _solvers('base_lr: 0.01 type: "LBFGS"')
