"""The PyTorch port's sequence-parallel slice against the JAX package:
K9's plain version, the ring attention, the mesh grammar, the
MultiHeadAttention layer in solver steps on an sp mesh, and
`-train -mesh 1,1,4` through both CLIs.

The JAX side runs as tests/test_parallel.py runs it: on the virtual CPU
devices tests/conftest.py sets up, its Pallas kernels in interpret mode
(`flash="interpret"`, COS_FLASH_INTERPRET=1).  The port runs its
kernels' plain versions, its ring ranks all on the CPU.  Inputs and
parameters are made with numpy from a seed and move as numpy.

Tolerances: K9 rtol 1e-5 (both sides compute the same f32 formulas
over the whole hop, in another summation order), with atol 1e-6 of the
largest finite element (acc sums signed terms, so a small element
carries the rounding of its large terms); the ring forward rtol
2e-4 / atol 2e-5 and its gradients rtol 5e-4 / atol 5e-5, in bf16 3e-2
and 6e-2 (tests/test_parallel.py:666-822); solver losses rtol 5e-4
(test_parallel.py:879); the CLI's losses and blobs rtol 1e-4 against
the JAX package (test_torch_lm_train.py) and 1e-5 against the port
without a mesh (the same arithmetic in another order).
"""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.ops.pallas_kernels import \
    flash_block_update as jax_flash_block_update
from caffeonspark_tpu.parallel import ParallelSolver as JaxParallelSolver
from caffeonspark_tpu.parallel import build_mesh as jax_build_mesh
from caffeonspark_tpu.parallel.mesh import \
    parse_mesh_spec as jax_parse_mesh_spec
from caffeonspark_tpu.parallel.sp import ring_attention as jax_ring_attention
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, convert
from caffeonspark_tpu_torch.config import Config
from caffeonspark_tpu_torch.data.queue_runner import to_device
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.ops.layers import flash_mesh
from caffeonspark_tpu_torch.parallel import sp
from caffeonspark_tpu_torch.parallel.mesh import build_mesh, parse_mesh_spec
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

CPU = torch.device("cpu")


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# K9: the flash block update
# ---------------------------------------------------------------------------

BH, TQ, TK, D = 4, 16, 32, 16
K9_CASES = [  # (causal, q_off, k_off)
    (True, 48, 0),      # q_off > k_off: every key visible
    (True, 16, 0),      # q_off > k_off: the edge runs through the block
    (True, 32, 32),     # q_off == k_off: the diagonal
    (True, 0, 32),      # q_off < k_off: every row masked
    (False, 0, 32),     # non-causal
]


def _carry(kind, seed):
    """The ring's first carry (-inf, 0, 0), or one from earlier hops:
    finite maxima with positive sums, and rows 0 and 5 left at -1e30 by
    a hop whose keys they could not see."""
    if kind == "first":
        return (np.full((BH, TQ), -np.inf, np.float32),
                np.zeros((BH, TQ), np.float32),
                np.zeros((BH, TQ, D), np.float32))
    rng = np.random.RandomState(seed)
    m = (rng.randn(BH, TQ) * 0.5 + 2.0).astype(np.float32)
    l = rng.uniform(1.0, 5.0, (BH, TQ)).astype(np.float32)
    acc = rng.randn(BH, TQ, D).astype(np.float32)
    m[:, [0, 5]] = -1e30
    l[:, [0, 5]] = 0.0
    acc[:, [0, 5]] = 0.0
    return m, l, acc


@pytest.mark.parametrize("carry", ["first", "mid"])
@pytest.mark.parametrize("causal,q_off,k_off", K9_CASES)
def test_flash_block_update_plain_matches_pallas(causal, q_off, k_off,
                                                 carry):
    """K9's plain version (through its wrapper, which takes it for a CPU
    tensor) against the Pallas kernel in interpret mode: the same (m', l',
    acc') from the same q, block and carry, -1e30 where a row saw no key
    and -inf nowhere it had seen one."""
    rng = np.random.RandomState(q_off * 7 + k_off + causal)
    q = rng.randn(BH, TQ, D).astype(np.float32)
    k = rng.randn(BH, TK, D).astype(np.float32)
    v = rng.randn(BH, TK, D).astype(np.float32)
    c = _carry(carry, q_off + k_off)
    want = jax.jit(functools.partial(
        jax_flash_block_update, causal=causal, block_q=TQ, block_k=TK,
        interpret=True))(*(jnp.asarray(x) for x in (q, k, v) + c), q_off,
                         k_off)
    before = dict(K.launch_counts)
    got = K.flash_block_update(*(torch.from_numpy(x) for x in (q, k, v) + c),
                               q_off, k_off, causal)
    assert K.launch_counts == before          # the plain version ran
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        w = np.asarray(w)
        scale = float(np.abs(w[np.isfinite(w)]).max(initial=0.0))
        _close(g.numpy(), w, 1e-5, 1e-6 * min(scale, 1e29), name)
    if causal and q_off < k_off:
        assert (got[0].numpy() == -1e30 if carry == "first"
                else got[0].numpy() == c[0]).all()
        _close(got[2].numpy(), c[2], 0.0)


def test_flash_block_update_refuses_other_carry_dtypes():
    q = torch.zeros(1, 4, 8)
    m = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="carry must be float32"):
        K.flash_block_update(q, q, q, m.bfloat16(), m, q, 0, 0, True)
    with pytest.raises(ValueError, match="carry must be float32"):
        K.flash_block_update(q, q, q, m, m, q.double(), 0, 0, True)


# ---------------------------------------------------------------------------
# the ring against the JAX ring
# ---------------------------------------------------------------------------

def _jax_ring(qkv, causal, flash, mesh):
    """JAX ring_attention's output and the gradients of sum(out²) (as
    f32) with respect to q, k, v, in one jit (eager shard_map is an
    order of magnitude slower)."""
    def both(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(
            q, k, v, mesh, causal=causal, flash=flash), q, k, v)
        return out, vjp((2.0 * out.astype(jnp.float32)).astype(out.dtype))
    out, grads = jax.jit(both)(*(jnp.asarray(x) for x in qkv))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_ring(qkv, causal, flash, mesh):
    xs = [torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        .requires_grad_(True) for x in qkv]
    out = sp.ring_attention(*xs, mesh, causal=causal, flash=flash)
    assert out.dtype == xs[0].dtype and out.shape == xs[0].shape
    grads = torch.autograd.grad((out.float() ** 2).sum(), xs)
    for g, x in zip(grads, xs):
        assert g.dtype == x.dtype
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


@pytest.fixture(scope="module")
def meshes():
    """The JAX dp2 x sp4 mesh of test_parallel.py and the port's sp4
    mesh, its 4 ranks on the CPU (the JAX dp replicas run one ring each
    over half the batch; the port's one ring takes the whole batch)."""
    return (jax_build_mesh(dp=2, sp=4),
            build_mesh(sp=4, devices=[CPU] * 4))


RING_CASES = [  # (t_q, t_k, dtype, causal, flash)
    (64, 64, np.float32, False, False),
    (64, 64, np.float32, True, False),
    (64, 64, np.float32, False, True),
    (64, 64, np.float32, True, True),
    (64, 128, np.float32, False, True),     # cross extents
    (64, 128, np.float32, True, True),
    (64, 64, jnp.bfloat16, True, True),
]


@pytest.mark.parametrize("t_q,t_k,dtype,causal,flash", RING_CASES)
def test_ring_attention_matches_jax(meshes, t_q, t_k, dtype, causal, flash):
    """ring_attention's forward and its gradients of sum(out²) against
    the JAX ring on a dp2 x sp4 mesh (the port's on sp4): the einsum
    ring, the fused ring
    (K9 forward, K7/K8 backward), the fused ring with unequal shard
    extents (einsum backward), and bf16 inputs."""
    rng = np.random.RandomState(t_k + 2 * causal + flash)
    b, h, d = 2, 2, 16
    qkv = [rng.randn(b, h, t, d).astype(np.float32).astype(dtype)
           for t in (t_q, t_k, t_k)]
    jmesh, tmesh = meshes
    want, gwant = _jax_ring(qkv, causal, "interpret" if flash else False,
                            jmesh)
    got, ggot = _port_ring(qkv, causal, flash, tmesh)
    fwd, grad = ((2e-4, 2e-5), (5e-4, 5e-5)) if dtype == np.float32 \
        else ((3e-2, 3e-2), (6e-2, 6e-2))
    _close(got, want, *fwd, "out")
    for name, g, w in zip("qkv", ggot, gwant):
        _close(g, w, *grad, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_fused_ring_launch_pattern(monkeypatch, causal):
    """The fused ring's calls on sp = 4: a causal forward folds n(n+1)/2
    = 10 hops (the causal hop skip), a non-causal one all 16; the
    backward runs K7/K8 on 4 diagonal pairs plus the 6 visitors from
    later shards (all 12 visitors when not causal), and the same
    output as the einsum ring."""
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = K.flash_block_update, K.flash_bwd_block

    def fwd(*a):
        calls["fwd"].append(a[6:9])          # (q_off, k_off, causal)
        return real_fwd(*a)

    def bwd(*a, **kw):
        calls["bwd"].append(kw["causal"])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(K, "flash_block_update", fwd)
    monkeypatch.setattr(K, "flash_bwd_block", bwd)
    mesh = build_mesh(sp=4, devices=[CPU] * 4)
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 32, 8).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    out = sp.ring_attention(q, k, v, mesh, causal=causal, flash=True)
    out.sum().backward()
    n = 4
    assert len(calls["fwd"]) == (n * (n + 1) // 2 if causal else n * n)
    assert calls["bwd"] == ([True] * n + [False] * (n * (n - 1) // 2)
                            if causal else [False] * n * n)
    if causal:
        assert all(q_off >= k_off for q_off, k_off, _ in calls["fwd"])
    ref = sp.ring_attention(q, k, v, mesh, causal=causal, flash=False)
    _close(out.detach(), ref.detach(), 2e-5, 2e-6)


def test_sp_shard_time_and_ppermute():
    """sp_shard_time cuts the time axis into the ranks' contiguous blocks
    and ppermute hands rank i's tensor to rank i + 1."""
    mesh = build_mesh(sp=4, devices=[CPU] * 4)
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    blocks = sp.sp_shard_time(x, mesh, time_axis=1)
    assert [tuple(b.shape) for b in blocks] == [(2, 2, 3)] * 4
    assert all(b.is_contiguous() for b in blocks)
    rot = sp.ppermute(blocks, mesh)
    for i in range(4):
        assert torch.equal(rot[i], blocks[(i - 1) % 4])
    with pytest.raises(ValueError, match="not divisible"):
        sp.sp_shard_time(torch.zeros(1, 1, 6, 2), mesh)


# ---------------------------------------------------------------------------
# the mesh grammar and layout
# ---------------------------------------------------------------------------

SPECS = ["4", "2,4", "1,1,4", "2,1,2,2", " 1 , 1 , 4 ", "pp=4",
         "tp=2,pp=2", "2,2,pp=2", "sp=4", "sp=2,dp=2", "1,1,1,1,1", "0",
         "2,-1", "pp=0", "pp=-2", "foo=2", "2,dp=2", "x", "", "1,,2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_spec(spec) == want


def test_build_mesh_layout_and_refusals():
    """The port's mesh has the JAX mesh's axes and extents; ranks share a
    device; `describe` gives the JAX MeshLayout's summary of an
    unsharded net; dp, tp, ep and pp > 1 are refused."""
    mesh = build_mesh(sp=4, devices=[CPU] * 4)
    jmesh = jax_build_mesh(dp=1, sp=4, devices=jax.devices()[:4])
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.size == 4 and mesh.axis_devices("sp") == [CPU] * 4
    assert build_mesh(devices=["cpu"]).shape == dict.fromkeys(
        ("pp", "ep", "sp", "tp", "dp"), 1)
    net = JaxNetParameter.from_text(jax_zoo.transformer_lm(
        vocab=12, d_model=8, heads=2, layers=1, seq=16, batch=2).to_text())
    from caffeonspark_tpu.net import Net as JaxNet
    from caffeonspark_tpu.parallel.mesh import MeshLayout as JaxMeshLayout
    assert mesh.describe() == JaxMeshLayout(JaxNet(net), jmesh).describe() \
        == {"axes": {"sp": 4}, "devices": 4, "sharded_params": []}
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh(sp=4, devices=[CPU] * 6)


@pytest.mark.parametrize("kw,n", [({"dp": 2}, 2), ({"tp": 2}, 2),
                                  ({"ep": 2}, 2), ({"pp": 2}, 2),
                                  ({"sp": 2}, 4)])
def test_build_mesh_refuses_axes_but_sp(kw, n):
    """ep and pp wait for MixtureOfExperts and the pipeline (ROADMAP
    Queue 1 item 8) and are refused by name; dp and tp build, also a dp
    that build_mesh infers from the devices left over (sp 2 on 4), with
    the extents the JAX package's build_mesh gives."""
    if "ep" in kw or "pp" in kw:
        with pytest.raises(ValueError, match="Queue 1 item 8"):
            build_mesh(devices=[CPU] * n, **kw)
        return
    mesh = build_mesh(devices=[CPU] * n, **kw)
    jmesh = jax_build_mesh(devices=jax.devices()[:n], **kw)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.size == n and mesh.axis_devices("dp") == \
        [CPU] * mesh.shape["dp"]


def test_config_mesh_flag():
    """-mesh parses with the JAX grammar at validate(); its axes are
    build_mesh's to refuse (test_cli_mesh_refusals); it applies to
    -train only."""
    conf = Config(["-mesh", "1,1,4"])
    conf.validate()
    assert conf.mesh == "1,1,4"
    Config(["-mesh", "2,1,4"]).validate()
    with pytest.raises(ValueError, match="must be >= 1"):
        Config(["-mesh", "1,1,0"]).validate()
    with pytest.raises(ValueError, match="applies to -train"):
        Config(["-mesh", "1,1,4", "-serve"]).validate()


# ---------------------------------------------------------------------------
# MultiHeadAttention on an sp mesh, through ParallelSolver
# ---------------------------------------------------------------------------

SP_SOLVER = ("base_lr: 0.01 momentum: 0.9 lr_policy: 'fixed' "
             "type: 'ADAM' random_seed: 5")


def test_mha_sp_mesh_routes_through_fused_ring(monkeypatch):
    """Two solver steps of transformer_lm(vocab 12, d_model 32, 2 heads,
    1 layer, T 128, batch 4) under an sp4 mesh's route (`flash_mesh`, as
    the processor takes them with -mesh): the port's losses match the
    JAX ParallelSolver's (its fused ring in interpret mode) on the same
    params and batch; a counter on _ring_attention_local shows the
    port's ring ran once a step, and without the mesh not at all, with
    the same losses to 1e-5."""
    text = jax_zoo.transformer_lm(vocab=12, d_model=32, heads=2, layers=1,
                                  seq=128, batch=4).to_text()
    rng = np.random.RandomState(0)
    seqs = rng.randint(0, 10, (128, 4)).astype(np.float32)
    batch = {"input_sentence": seqs, "target_sentence": (seqs + 1) % 10}

    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    js = JaxSolver(JaxSolverParameter.from_text(SP_SOLVER),
                   JaxNetParameter.from_text(text))
    jps = JaxParallelSolver(js, jax_build_mesh(dp=1, sp=4,
                                               devices=jax.devices()[:4]))
    jp, jst = jps.init()
    arrays = {ln: {bn: np.asarray(jax.device_get(a)) for bn, a in bl.items()}
              for ln, bl in jp.items()}
    jstep = jps.train_step()
    want = []
    for i in range(2):
        jp, jst, out = jstep(jp, jst, jps.shard_batch(batch), js.step_rng(i))
        want.append(float(out["loss"]))

    ring_calls = []
    real_local = sp._ring_attention_local

    def counting_local(*a, **kw):
        ring_calls.append(kw["flash"])
        return real_local(*a, **kw)

    monkeypatch.setattr(sp, "_ring_attention_local", counting_local)

    def run(mesh):
        ring_calls.clear()
        s = Solver(SolverParameter.from_text(SP_SOLVER),
                   NetParameter.from_text(text), device="cpu")
        p = convert.params_from_numpy(s.train_net, arrays)
        st = s.init_state(p)
        losses = []
        for _ in range(2):
            with (flash_mesh(mesh) if mesh else contextlib.nullcontext()):
                losses.append(float(s.train_step(
                    p, st, to_device(batch, CPU))[0]))
        return losses, list(ring_calls)

    l_ring, calls = run(build_mesh(sp=4, devices=[CPU] * 4))
    assert calls == [True, True]
    l_single, calls_single = run(None)
    assert calls_single == []
    assert np.isfinite(l_ring).all()
    _close(l_ring, want, 5e-4)
    _close(l_ring, l_single, 1e-5)


def test_flash_mesh_is_per_thread():
    """A mesh installed on one thread does not reach another (a serving
    thread beside a training step): the other thread's attention takes
    the single-device route."""
    import threading
    mesh = build_mesh(sp=4, devices=[CPU] * 4)
    seen = []
    real = sp.ring_attention
    x = torch.randn(1, 2, 8, 4)

    def record(*a, **kw):
        seen.append(threading.current_thread().name)
        return real(*a, **kw)

    from caffeonspark_tpu_torch.ops import layers as L
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "ring_attention", record)
        with flash_mesh(mesh):
            t = threading.Thread(target=lambda: L._attention_dispatch(
                x, x, x, causal=True), name="other")
            t.start()
            t.join()
            L._attention_dispatch(x, x, x, causal=True)
    assert seen == [threading.current_thread().name]


# ---------------------------------------------------------------------------
# -train -mesh 1,1,4 through both CLIs
# ---------------------------------------------------------------------------

LM = dict(vocab=16, d_model=32, heads=2, layers=1, seq=128, batch=4)
ADAM = ('type: "Adam" base_lr: 0.001 momentum: 0.9 momentum2: 0.999 '
        'delta: 1e-8 lr_policy: "fixed" random_seed: 1')


def _write_lm(tmp_path):
    """12 JSON rows of LM['seq'] + 1 seeded tokens, the zoo's LM on a
    DataFrameSource over them, and an Adam solver of 4 steps with
    snapshots at 2."""
    rows = tmp_path / "rows.json"
    rng = np.random.RandomState(9)
    with open(rows, "w") as f:
        for _ in range(12):
            toks = rng.randint(0, LM["vocab"], LM["seq"] + 1).tolist()
            f.write(json.dumps({"input_sentence": toks[:-1],
                                "target_sentence": toks[1:]}) + "\n")
    npm = jax_zoo.transformer_lm(**LM)
    npm.layer[0].source_class = "com.yahoo.ml.caffe.DataFrameSource"
    npm.layer[0].cos_data_param.source = str(rows)
    npm.layer[0].cos_data_param.dataframe_format = "json"
    net_path = tmp_path / "net.prototxt"
    net_path.write_text(npm.to_text())
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net_path}"\n{ADAM}\nmax_iter: 4\n'
                      'snapshot: 2\nsnapshot_prefix: "lm"\n')
    return str(solver), net_path.read_text()


@pytest.mark.parametrize("spec,match", [
    ("2,1,4", None), ("1,2,4", None), ("1,1,3", "does not divide"),
    ("1,1,1,2", "Queue 1 item 8"), ("pp=2", "Queue 1 item 8")])
def test_cli_mesh_refusals(tmp_path, spec, match):
    """-train -mesh with an ep or pp axis (ROADMAP Queue 1 item 8), or an
    sp that does not divide the LM's 128 time steps, is refused when the
    processor builds its mesh, before a step runs.  dp 2 × sp 4 and
    tp 2 × sp 4 train, to the final blobs of the run without -mesh
    (within 1e-5)."""
    solver, _ = _write_lm(tmp_path)
    out = tmp_path / "out"
    argv = ["-conf", solver, "-train", "-output", str(out), "-device",
            "cpu", "-mesh", spec]
    if match is not None:
        with pytest.raises(ValueError, match=match):
            caffe_on_spark.main(argv)
        assert not out.exists()
        return
    assert caffe_on_spark.main(argv) == 0
    assert caffe_on_spark.main(argv[:4] + [str(tmp_path / "one")]
                               + argv[5:-2]) == 0
    got = checkpoint.load_caffemodel_blobs(str(out / "model.caffemodel"))
    want = checkpoint.load_caffemodel_blobs(
        str(tmp_path / "one" / "model.caffemodel"))
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            _close(g, w, 1e-5, 1e-7, ln)


def test_cli_train_mesh_matches_jax_cli(tmp_path, monkeypatch):
    """-train -mesh 1,1,4 -device cpu of the port against the JAX CLI
    (-devices 4 -mesh 1,1,4, its ring in interpret mode) from one
    -weights .caffemodel on the same rows: the snapshot and final blobs
    to rtol 1e-4, and the port's per-step losses against the JAX
    ParallelSolver replaying the same feed on the same mesh.  The port
    without -mesh trains the same model within 1e-5."""
    solver, net_text = _write_lm(tmp_path)
    ts = Solver(SolverParameter.from_text(ADAM),
                NetParameter.from_text(net_text), device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, ts.train_net, ts.train_net.init(21))

    def port(out, *extra):
        metrics = str(tmp_path / f"{out}.json")
        monkeypatch.setenv("COS_PIPELINE_METRICS", metrics)
        assert caffe_on_spark.main(["-conf", solver, "-train", "-weights",
                                    init, "-output", str(tmp_path / out),
                                    "-device", "cpu", *extra]) == 0
        monkeypatch.delenv("COS_PIPELINE_METRICS")
        with open(metrics) as f:
            return json.load(f)["info"]

    info = port("t", "-mesh", "1,1,4")
    assert info["mesh"] == {"axes": {"sp": 4}, "devices": 4,
                            "sharded_params": []}
    assert info["train"]["iter"] == [1, 2, 3, 4]
    single = port("s")
    assert "mesh" not in single
    _close(info["train"]["loss"], single["train"]["loss"], 1e-5)

    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    assert jax_cos.main(["-conf", solver, "-train", "-weights", init,
                         "-output", str(tmp_path / "j"), "-devices", "4",
                         "-mesh", "1,1,4"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == [
        "lm_iter_2.caffemodel", "lm_iter_2.solverstate",
        "lm_iter_4.caffemodel", "lm_iter_4.solverstate",
        "model.caffemodel"]
    for name in ("lm_iter_2.caffemodel", "model.caffemodel"):
        got = checkpoint.load_caffemodel_blobs(str(tmp_path / "t" / name))
        plain = checkpoint.load_caffemodel_blobs(str(tmp_path / "s" / name))
        want = jax_ckpt.load_caffemodel_blobs(str(tmp_path / "j" / name))
        assert set(got) == set(want) == set(plain)
        for ln in want:
            for g, p, w in zip(got[ln], plain[ln], want[ln]):
                _close(g, w, 1e-4, 1e-6, f"{name} {ln}")
                _close(g, p, 1e-5, 1e-7, f"{name} {ln} without -mesh")

    # the JAX ParallelSolver on the feed both CLIs see: per-epoch
    # shuffled rows (source seed 0, as -train builds it) in batches of 4
    jl = JaxNetParameter.from_text(net_text).layer[0]
    jsrc = jax_get_source(jl, phase_train=True)
    feed = [r for e in range(2) for r in jsrc.shuffled_records(e)]
    js = JaxSolver(JaxSolverParameter.from_text(ADAM),
                   JaxNetParameter.from_text(net_text))
    jps = JaxParallelSolver(js, jax_build_mesh(dp=1, sp=4,
                                               devices=jax.devices()[:4]))
    blobs = jax_ckpt.load_caffemodel_blobs(init)
    jp = jps.shard_params(
        {ln: {bn: jnp.asarray(a) for (bn, _, _), a in zip(specs, blobs[ln])}
         for ln, specs in js.train_net.param_layout.items()})
    jst = jps.shard_opt_state(js.init_state(jp))
    step = jps.train_step()
    losses = []
    for it in range(4):
        b = jsrc.pack_batch(feed[4 * it:4 * it + 4])
        jp, jst, out = step(jp, jst, jps.shard_batch(b), js.step_rng(it))
        losses.append(float(out["loss"]))
    _close(info["train"]["loss"], losses, 1e-4)
