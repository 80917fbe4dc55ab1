"""Training under a mesh on the port (the dense decoders' train step on
DTensors, `repro_torch.launch.train.run(mesh=)`) against the reference's
`make_train_step` jitted under its `activate`.

The port runs as two 4-rank gloo jobs (`repro_torch.launch.mhrun`, rank
code `tests/torch_shard_worker.py::scenario_mesh_train`), one on a (2, 2)
and one on a (1, 4) ('data', 'model') mesh. The reference runs in this
process on an `AxisType.Auto` mesh of four of the eight emulated devices
(its `jax.make_mesh` meshes are Explicit, where its constraint fails:
ROADMAP.md §C), params placed by its `tree_shardings`, the same weights
on both sides (the reference's draw, carried across). Cases: the reduced
smollm-360m under `TRAIN_RULES` and phi4-mini-3.8b under `TRAIN_RULES_TP`
on (2, 2), phi4-mini-3.8b under `TRAIN_RULES` on (1, 4), each at float32
and bfloat16, 2 layers, batch 4 of 32 tokens. Reduced, the two configs
have the same shapes (they differ only in width). On (1, 4) the 2 KV
heads do not divide the 4 'model' ranks: `split_heads` gathers K and V,
and that gather's backward runs here.

Held to the reference, per case: the loss and every gradient leaf of the
first batch; each gradient's placements against the spec the reference's
step keeps its params and optimizer state in (its `tree_shardings`); the
metrics of three chained steps with gradient compression; the params and
Adam's m and v after them, and the layout of those and of the residuals.

Tolerances, each with its reason:

* float32 loss 1e-5 relative, gradients 1e-5 * max|g| plus 1e-4 relative
  (`tests/test_torch_train.py`'s bound for the unsharded step: the same
  float32 math, partial sums added in other orders, XLA's `rsqrt`/`cos`/
  `sin` a few ulps from torch's).
* bfloat16: max(2e-2, d) of max|x|, d the reference's own distance between
  its sharded and unsharded runs of the same quantity; twice that for
  Adam's v, which holds squares (a relative error e in g is 2e in g^2),
  and the params' bound plus 2 * the sum of the steps' lr (Adam's steps
  are normalized: a gradient a few percent off moves a value's step by up
  to about lr).
* After the chained steps at float32: a gradient code k = round(g / delta)
  rounds to the other neighbour where the two packages' gradients
  straddle a midpoint; the step's gradient then moves by delta and that
  value's Adam step by up to about lr. At most `FLIP_SHARE` of a leaf's
  values may be off by more than 1e-5 * max|x|, params by at most 2 * the
  sum of the steps' lr, m and v by at most `FLIPPED_STATE` of max|x|.
"""

import os
import pickle
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as r_get_config
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import build_model as r_build_model
from repro.models import nn as r_nn
from repro.models import reduced_for_smoke as r_reduced
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import GradCompressConfig as RGradCompressConfig
from repro.runtime import sharding as r_sh
from repro.runtime import steps as r_steps
from repro_torch.launch import train

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

MESH_CASES = {
    (2, 2): [("smollm-360m", "TRAIN_RULES", "float32"), ("smollm-360m", "TRAIN_RULES", "bfloat16"),
             ("phi4-mini-3.8b", "TRAIN_RULES_TP", "float32"),
             ("phi4-mini-3.8b", "TRAIN_RULES_TP", "bfloat16")],
    (1, 4): [("phi4-mini-3.8b", "TRAIN_RULES", "float32"),
             ("phi4-mini-3.8b", "TRAIN_RULES", "bfloat16")],
}
CASES = [(shape, case) for shape, cases in MESH_CASES.items() for case in cases]
LAYERS, SEQ, BATCH, STEPS, EB_REL = 2, 32, 4, 3, 1e-3
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=5)
LOSS_RTOL, F32_ATOL, F32_RTOL, BF16_FLOOR = 1e-5, 1e-5, 1e-4, 2e-2
FLIP_SHARE, FLIPPED_STATE = 5e-3, 1e-2
#: the launcher: 4 compressed steps (an async save at step 2, the final
#: save at 4), then a resume to step 6, on the mesh and unsharded
LAUNCH = ["--device", "cpu", "--smoke", "--n-layers", "2", "--seq", "32", "--batch", "4",
          "--lr", "1e-3", "--log-every", "100", "--steps", "4", "--ckpt-every", "2",
          "--compress-grads"]
RESUME_STEPS = 6


def _id(c) -> str:
    shape, (arch, rules, dtype) = c
    return f"{shape[0]}x{shape[1]}-{arch}-{rules}-{dtype}"


def _key(case) -> str:
    return "/".join(case)


def _r_mesh(devices, shape):
    return Mesh(np.array(devices[: int(np.prod(shape))]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * len(shape))


def _r_model(arch, dtype):
    return r_build_model(r_reduced(r_get_config(arch)).scaled(n_layers=LAYERS, dtype=dtype))


def _named(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _host(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in _named(tree).items()}


def _pad(spec, ndim) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _r_run(model, flat, batches, mesh=None, rules=None) -> dict:
    """The reference's loss and gradients of the first batch and its
    chained compressed steps, under `activate(mesh, rules)` when given:
    host copies, and the specs of the step's params and state."""
    params = W.nest({k: jnp.asarray(v) for k, v in flat.items()})
    if mesh is not None:
        desc = model.desc()
        shard = r_sh.tree_shardings(r_nn.axes_tree(desc), rules, mesh, r_nn.abstract_tree(desc))
        params = jax.tree_util.tree_map(jax.device_put, params, shard)
    gc = RGradCompressConfig(eb_rel=EB_REL)
    step = r_steps.make_train_step(model, RAdamWConfig(**OPT), gc)

    def both(params, opt, batch):
        (loss, aux), grads = jax.value_and_grad(model.loss, has_aux=True)(params, batch)
        return loss, grads, step(params, opt, batch)

    def body():
        nonlocal params
        fn = jax.jit(both)
        opt = r_steps.init_opt_state(params, gc)
        metrics = []
        for i, b in enumerate(batches):
            loss, grads, (params, opt, m) = fn(params, opt, b)
            if i == 0:
                first = (float(loss), _host(grads))
            metrics.append({k: float(v) for k, v in m.items()})
        specs = None if mesh is None else {
            f"{part}/{k}": _pad(v.sharding.spec, v.ndim) for part, tree in (
                ("params", params), ("m", opt["adam"]["m"]), ("v", opt["adam"]["v"]),
                ("residual", opt["gc"]["residual"])) for k, v in _named(tree).items()}
        return dict(loss=first[0], grads=first[1], metrics=metrics, params=_host(params),
                    m=_host(opt["adam"]["m"]), v=_host(opt["adam"]["v"]), specs=specs)

    if mesh is None:
        return body()
    with r_sh.activate(mesh, rules):
        return body()


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def results(tmp_path_factory, emulated_devices):
    """Both meshes' jobs, run in threads while the reference runs here:
    ({mesh: (payloads, record)}, {(mesh, case): reference}, {dtype: the
    reference's unsharded run}, the port's unsharded launcher). The jobs'
    hard limit is far above their ~30 s alone: under a loaded test run
    they share the cores with everything else."""
    model = _r_model("smollm-360m", "float32")
    drawn = r_nn.init_tree(model.desc(), jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in _named(drawn).items()}
    jobs, errors = {}, []
    # made here, not in the threads: the first use of the factory in a
    # process clears its base directory, so two first uses at once race
    dirs = {shape: tmp_path_factory.mktemp(f"mesh_train_{shape[0]}x{shape[1]}")
            for shape in MESH_CASES}

    def run(shape):
        wd = dirs[shape]
        np.savez(wd / "weights.npz", **flat)
        try:
            payloads = W.run_job("mesh_train", 4, wd, timeout_s=600, args=dict(
                mesh=list(shape), cases=MESH_CASES[shape], layers=LAYERS, seq=SEQ, batch=BATCH,
                steps=STEPS, eb_rel=EB_REL, opt=OPT,
                launcher=dict(argv=LAUNCH, resume_steps=RESUME_STEPS)))
        except AssertionError as e:  # reported below, in the test's thread
            errors.append(e)
            return
        with open(wd / "mesh_train.pkl", "rb") as f:
            jobs[shape] = (payloads, pickle.load(f))

    threads = [threading.Thread(target=run, args=(s,)) for s in MESH_CASES]
    for t in threads:
        t.start()
    dcfg = RDataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    batches = [{k: jnp.asarray(v) for k, v in r_synthetic_batch(dcfg, s).items()}
               for s in range(STEPS)]
    ref, plain = {}, {}
    for shape, case in CASES:
        arch, rules, dtype = case
        rmodel = _r_model(arch, dtype)
        ref[shape, case] = _r_run(rmodel, flat, batches, _r_mesh(emulated_devices, shape),
                                  getattr(r_sh, rules))
        if dtype == "bfloat16" and dtype not in plain:  # the reduced configs are one model
            plain[dtype] = _r_run(rmodel, flat, batches)
    wd = tmp_path_factory.mktemp("mesh_train_unsharded")
    first = train.main(LAUNCH + ["--ckpt-dir", str(wd)])
    again = train.main(LAUNCH + ["--ckpt-dir", str(wd), "--steps", str(RESUME_STEPS), "--resume"])
    for t in threads:
        t.join(660)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return jobs, ref, plain, (first["losses"], again["losses"])


def _bound(results, shape, case, part, name=None) -> float:
    """max(2e-2, d): d the reference's own sharded-vs-unsharded distance of
    `part` (a leaf of it when `name` is given, else the loss)."""
    _, ref, plain, _ = results
    s, u = ref[shape, case], plain[case[2]]
    d = _rel(s[part][name], u[part][name]) if name is not None else _rel(s[part], u[part])
    return max(BF16_FLOOR, d)


def _got(results, shape, case) -> dict:
    return results[0][shape][1]["cases"][_key(case)]


@pytest.mark.parametrize("shape,case", CASES, ids=[_id(c) for c in CASES])
def test_loss_and_grads_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert got["tokens"] == BATCH * SEQ
    assert sorted(got["grads"]) == sorted(want["grads"])
    if case[2] == "float32":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    else:
        assert _rel(got["loss"], want["loss"]) <= _bound(results, shape, case, "loss")
    for k, w in want["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max())
        if case[2] == "float32":
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL * scale, err_msg=k)
        else:
            assert _rel(g, w) <= _bound(results, shape, case, "grads", k), (k, _rel(g, w))


def _split(spec, shape) -> list:
    """`spec` without the mesh dims of size 1 (a split over one rank is no
    split; the reference's compiled step drops them from its specs)."""
    sizes = dict(zip(("data", "model"), shape))
    out = []
    for e in spec:
        names = [n for n in ([e] if isinstance(e, str) else e or []) if sizes[n] > 1]
        out.append(None if not names else names[0] if len(names) == 1 else names)
    return out


@pytest.mark.parametrize("shape,case", CASES, ids=[_id(c) for c in CASES])
def test_placements_match_reference(results, shape, case):
    """Each gradient in its param's placements, and the params, m, v and the
    residuals after the steps where the reference's step keeps them."""
    got, want = _got(results, shape, case), results[1][shape, case]
    assert sorted(got["specs"]) == sorted(want["specs"])
    for k, spec in got["specs"].items():
        assert _split(spec, shape) == _split(want["specs"][k], shape), k
    for k, spec in got["grad_specs"].items():
        assert spec == got["specs"][f"params/{k}"], k
    if case[1] == "TRAIN_RULES" and shape == (2, 2):  # FSDP: the weights' embed dim over 'data'
        assert got["specs"]["params/blocks/attn/wq"] == [None, "data", "model"]
        assert got["specs"]["params/embed"] == ["model", "data"]


#: the collectives a forward and backward may issue: DTensor's all-reduce
#: (a pending sum that ends; gloo runs it on CUDA tensors) and the port's
#: own host-staged all-gathers, reduce-scatters and all-reduces. DTensor's
#: own all-gather of CUDA tensors over gloo kills the rank (PERF.md §6),
#: so it may not plan one.
ALLOWED_COLLECTIVES = {"c10d_functional.all_reduce", "c10d.allgather_",
                       "c10d._reduce_scatter_base_", "c10d.allreduce_"}


@pytest.mark.parametrize("shape,case", CASES, ids=[_id(c) for c in CASES])
def test_backward_plans_no_collective_of_dtensors_own_but_all_reduce(results, shape, case):
    comm = _got(results, shape, case)["comm"]
    assert set(comm) <= ALLOWED_COLLECTIVES, comm
    assert comm["c10d_functional.all_reduce"] > 0
    fsdp = case[1] == "TRAIN_RULES" and shape == (2, 2)
    assert (comm.get("c10d._reduce_scatter_base_", 0) > 0) == (fsdp or shape == (1, 4)), comm


@pytest.mark.parametrize("shape,case", CASES, ids=[_id(c) for c in CASES])
def test_chained_compressed_steps_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert got["step"] == STEPS and len(got["metrics"]) == STEPS
    f32 = case[2] == "float32"
    lr_sum = 0.0
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert sorted(g) == sorted(w)
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        lr_sum += w["lr"]
        if f32:
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL, err_msg=str(i))
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, err_msg=str(i))
            np.testing.assert_allclose(g["wire_bits_per_value"], w["wire_bits_per_value"],
                                       rtol=1e-3, err_msg=str(i))
        else:
            bound = max(_bound(results, shape, case, "loss"), BF16_FLOOR)
            for k in ("loss", "grad_norm", "wire_bits_per_value"):
                assert _rel(g[k], w[k]) <= bound, (i, k, g[k], w[k])
    for part in ("params", "m", "v"):
        for k, w in want[part].items():
            g = got[part][k]
            err, scale = np.abs(g - w), float(np.abs(w).max())
            if not f32:
                slack = 2 * lr_sum if part == "params" else 0.0
                bound = _bound(results, shape, case, part, k) * (2 if part == "v" else 1)
                assert float(err.max()) <= bound * scale + slack, (part, k, float(err.max()))
                continue
            off = int((err > F32_ATOL * scale).sum())
            assert off <= FLIP_SHARE * err.size, (part, k, off)
            most = 2 * lr_sum if part == "params" else FLIPPED_STATE * scale
            assert float(err.max()) <= F32_ATOL * scale + most, (part, k, float(err.max()))


@pytest.mark.parametrize("shape", list(MESH_CASES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_rank_reports_the_same_losses(results, shape):
    payloads, _ = results[0][shape]
    for p in payloads[1:]:
        assert p["losses"] == payloads[0]["losses"] and p["launcher"] == payloads[0]["launcher"]
    assert payloads[0]["backend"] == "gloo"


@pytest.mark.parametrize("shape", list(MESH_CASES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_gather_backward_is_the_plain_gradients_box(results, shape):
    """The gradient through the host-staged gather, replicated (each rank
    keeps its rows) and pending (a reduce-scatter over uneven shards),
    equals each rank's box of the plain gradient (float64: 1e-12); so does
    a dim split over both mesh dims, gathered the last split first and
    scattered back the first first (its forward exact)."""
    payloads, _ = results[0][shape]
    rows = set()
    for p in payloads:
        c = p["gather_backward"]
        assert c["replicated"]["placements"] == ["model", None]
        assert c["replicated"]["err"] <= 1e-12
        assert c["pending"]["placements"] == ["model", None]
        assert c["pending"]["err"] <= 1e-12 * c["pending"]["scale"]
        assert c["nested"]["placements"] == [["data", "model"], None]
        assert c["nested"]["forward"] == 0.0 and c["nested"]["err"] <= 1e-12
        rows.add(c["replicated"]["rows"])
    assert rows == ({2, 1} if shape == (1, 4) else {4, 3})  # uneven chunks of 7


@pytest.mark.parametrize("shape", list(MESH_CASES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_launcher_on_a_mesh_matches_unsharded(results, shape):
    """`launch.train.run(mesh=)` (compressed steps, an async save, the
    final save, a resume) against the port's unsharded launcher on the same
    arguments: the losses of both runs, bfloat16 compute (the smoke
    config), within 2e-2; the params laid out by `TRAIN_RULES`."""
    first, again = results[3]
    got = results[0][shape][1]["launcher"]
    assert len(got["losses"]) == len(first) == 4 and len(got["resumed"]) == len(again) == 2
    for g, w in zip(got["losses"] + got["resumed"], first + again):
        assert abs(g - w) <= BF16_FLOOR * abs(w), (g, w)
    assert got["params_specs"]["blocks/mlp/w_up"] == [None, "data", "model"]


def test_launcher_keeps_the_reference_flags():
    """A mesh enters only through `run(mesh=)`: no flag is added."""
    assert "mesh" not in vars(train.parse_args([]))
