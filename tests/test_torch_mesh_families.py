"""The vision frontend, the encoder-decoder, the hybrid and xLSTM under a
mesh on the port against the reference under its `activate`.

The port runs as two 4-rank gloo jobs (`repro_torch.launch.mhrun`, rank
code `tests/torch_shard_worker.py::scenario_mesh_families`), one on a
(2, 2) and one on a (1, 4) ('data', 'model') mesh. The reference runs on
an `AxisType.Auto` mesh of four of the eight emulated devices (the oracle
of tests/test_torch_mesh_moe.py), params placed by its `tree_shardings`:
its serving in this process, its training in a process of its own (this
file run by `mhrun`, `scenario_reference_train`), so that the two sets of
compiles, which take most of the file's time, overlap. The models are the reduced internvl2-76b (16 patch
embeddings before the tokens), seamless-m4t-large-v2 (2 encoder and 4
decoder layers over 16 frames), zamba2-1.2b (two groups of 2 Mamba2
layers with the shared attention, a tail of 1) and xlstm-1.3b (two groups
of an mLSTM and an sLSTM), with 4 query heads (2 or 4 KV heads); their
weights are drawn once from numpy by the reference's descriptors and
carried to both packages.

* Serving under `SERVE_RULES` (`launch.serve.run_static(mesh=)`): each
  model at float32 on both meshes and at bfloat16 on (2, 2), batch 8, a prefill of 13 tokens (padded
  to the 16-step chunk by the recurrent blocks) and 7 teacher-forced
  decode steps; `max_len` 21 (37 with the patches) is no head count and
  no stack is 8 long, so the size matching meets nothing by accident (the
  forward without a cache is held by the training cases' loss, at rtol
  1e-5). The cache leaves that take
  'model' are the attention K/V (their 4 KV heads, or internvl2's 2 on
  (2, 2)), the mLSTM's C, n and m and the sLSTM's c, n, m and h (their 4
  heads); zamba2's h (16 SSD heads), the conv windows and the encoder
  memory are split by the batch only.
* Training at float32, each family once: zamba2 and xlstm under
  `TRAIN_RULES` on (2, 2) (FSDP over 'data', TP over 'model'), seamless
  under `TRAIN_RULES_TP` on (2, 2), internvl2 under `TRAIN_RULES` on
  (1, 4) (its 2 KV heads gathered over 4 ranks); 2 layers, batch 4 of 32
  tokens with frames or patches where the model takes them: the loss and
  every gradient and its placement against the reference's step, three
  chained compressed steps, and the collectives DTensor plans itself.
* Layouts: `cache_sharding` of every recurrent and memory cache against
  the reference's, and each family's `init_cache` under a mesh.

Tolerances are those of tests/test_torch_mesh.py (serving) and
tests/test_torch_mesh_train.py (training), with two rules for the chained
compressed steps: the params take tests/test_torch_train_families.py's
rule for the recurrences (a share of values moved by flipped gradient
codes), and Adam's m and v, which carry a flipped code whole, may have as
many values off the reference as the port's unsharded run has (measured:
10 of zamba2's 32 `mamba_groups/D` values in m, sharded and unsharded
alike) plus that share. At bfloat16 the served logits are held to max(2e-2, d) of
max|logit|, d the larger of the reference's own sharded-vs-unsharded
distance and its own bfloat16-vs-float32 distance (tests/test_torch_ssm.py's
rule): through the recurrences a bfloat16 rounding flip grows, so no port
is held closer than bfloat16 moves the reference itself. For the hybrid
and xLSTM the bound is max(2e-2, 2d): the reference's sharded run moves
by d from its own unsharded one (0.027 for xLSTM on (2, 2)), the port's
by about a third of that from its own (0.0085), in another direction,
and two runs that each lie within d of a common run lie within 2d of
each other (tests/test_torch_mesh_moe.py's rule for the routed experts).
"""

import argparse
import dataclasses
import os
import pickle
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import nn as r_nn
from repro.models import reduced_for_smoke as r_reduced
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import GradCompressConfig as RGradCompressConfig
from repro.runtime import sharding as r_sh
from repro.runtime import steps as r_steps
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch import serve
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.runtime import sharding as rsh

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

VISION, ENCDEC = "internvl2-76b", "seamless-m4t-large-v2"
HYBRID, XLSTM = "zamba2-1.2b", "xlstm-1.3b"
ARCHS = [VISION, ENCDEC, HYBRID, XLSTM]
MESHES = [(2, 2), (1, 4)]
PROMPT, GEN, BATCH_SERVE = 13, 8, 8
SERVE_CASES = [(a, d, BATCH_SERVE) for a in ARCHS for d in ("float32", "bfloat16")]
#: the meshes each dtype is served on (bfloat16 on (2, 2) only: the
#: reference's compiles take most of the file's time)
SERVE_MESHES = {"float32": [(2, 2), (1, 4)], "bfloat16": [(2, 2)]}
SERVED = [(shape, case) for case in SERVE_CASES for shape in SERVE_MESHES[case[1]]]
TRAIN_CASES = {
    (2, 2): [(HYBRID, "TRAIN_RULES", "float32"), (XLSTM, "TRAIN_RULES", "float32"),
             (ENCDEC, "TRAIN_RULES_TP", "float32")],
    (1, 4): [(VISION, "TRAIN_RULES", "float32")],
}
TRAIN = [(shape, case) for shape, cases in TRAIN_CASES.items() for case in cases]
#: the families whose bfloat16 logits go through recurrences (the 2d bound)
RECURRENT = {HYBRID, XLSTM}
LAYERS = 2
SEQ, BATCH, STEPS, EB_REL = 32, 4, 3, 1e-3
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=5)
DECODE_F32, BF16_FLOOR = 1e-3, 2e-2
BF16_ULP = 2.0 ** -7
LOSS_RTOL, F32_ATOL, F32_RTOL = 1e-5, 1e-5, 1e-4
FLIP_SHARE, FLIPPED_STATE, ADAM_OUTLIERS = 2e-2, 1e-2, 8
#: per-head and per-channel vectors whose placement the reference's
#: compiled step leaves to GSPMD, which splits them over 'model' (their
#: gradients come from head-split work); the port keeps them on the rules'
RELAID = ("/A_log", "/D", "/dt_bias", "/out_norm", "/if_bias", "/s/bias", "/s/r")
ALLOWED_COLLECTIVES = {"c10d_functional.all_reduce", "c10d.allgather_",
                       "c10d._reduce_scatter_base_", "c10d.allreduce_"}
#: each family's `init_cache` under a mesh: (arch, batch, max_len)
INIT_CACHE = [(a, BATCH_SERVE, PROMPT + GEN) for a in ARCHS]


def _r_mesh(devices, shape):
    return Mesh(np.array(devices[: int(np.prod(shape))]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * len(shape))


def _stand_in(shape):
    """What `cache_sharding` reads of a mesh: its dim names and shape."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.arange(int(np.prod(shape))).reshape(shape))


def _named(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _host(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in _named(tree).items()}


def _pad(spec, ndim) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _draw(desc, seed=0) -> dict:
    """Numpy weights by the reference's descriptors (`repro.models.nn`'s
    rule: zeros, ones, normal draws times the scale), flat by name."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "zeros":
            return np.zeros(p.shape, np.float32)
        if p.init == "ones":
            return np.ones(p.shape, np.float32)
        scale = p.scale
        if scale is None:
            fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else p.shape[0]
            scale = 0.02 if p.init == "embed" else 1.0 / np.sqrt(max(fan_in, 1))
        return (rng.standard_normal(p.shape) * scale).astype(np.float32)

    return _named(jax.tree_util.tree_map(draw, desc, is_leaf=r_nn.is_desc))


def _r_cfg(arch, **over):
    return r_reduced(r_get_config(arch)).scaled(**over)


def _weights():
    """{file name: flat weights}: each model's serving and training weights."""
    out = {}
    for arch in ARCHS:
        out[f"weights-{arch}.npz"] = _draw(r_build_model(_r_cfg(arch)).desc())
        out[f"train-{arch}.npz"] = _draw(r_build_model(_r_cfg(arch, n_layers=LAYERS)).desc(), 1)
    return out


def _max_len(cfg) -> int:
    """`run_static`'s cache length: the patches' rows, the prompt, the steps."""
    return (cfg.frontend_len if cfg.frontend == "vision" else 0) + PROMPT + GEN


# -- the reference ------------------------------------------------------------


def _placed(flat, model_desc, rules, mesh):
    params = W.nest({k: jnp.asarray(v) for k, v in flat.items()})
    if mesh is None:
        return params
    shard = r_sh.tree_shardings(r_nn.axes_tree(model_desc), rules, mesh,
                                r_nn.abstract_tree(model_desc))
    return jax.tree_util.tree_map(jax.device_put, params, shard)


def _r_serve(arch, dtype, flat, teacher, mesh):
    """The reference's prefill (on `run_static`'s prompts and frontend
    inputs) and teacher-forced decode steps (last-position logits per
    step), and under a mesh the param and cache specs."""
    cfg = _r_cfg(arch, dtype=dtype)
    model = r_build_model(cfg)
    params = _placed(flat, model.desc(), r_sh.SERVE_RULES, mesh)
    rng = np.random.default_rng(0)
    inputs = dict(tokens=rng.integers(1, cfg.vocab, (BATCH_SERVE, PROMPT)).astype(np.int32),
                  **W.frontend_inputs(cfg, BATCH_SERVE, rng))
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    prefill = jax.jit(r_steps.make_prefill_step(model))
    decode = jax.jit(lambda p, t, c: model.forward(p, {"tokens": t}, cache=c))

    def body():
        cache = model.init_cache(BATCH_SERVE, _max_len(cfg))
        logits, cache = prefill(params, batch, cache)
        out = [np.asarray(logits[:, -1], np.float32)]
        for i in range(GEN - 1):
            lg, cache = decode(params, teacher[:, i:i + 1], cache)
            out.append(np.asarray(lg[:, -1], np.float32))
        return out

    if mesh is None:
        return body(), None
    with r_sh.activate(mesh, r_sh.SERVE_RULES):
        runs = body()
    desc, cdesc = model.desc(), model.cache_desc(BATCH_SERVE, _max_len(cfg))
    pspec = r_sh.tree_shardings(r_nn.axes_tree(desc), r_sh.SERVE_RULES, mesh, r_nn.abstract_tree(desc))
    cspec = r_sh.cache_sharding(cdesc, mesh, BATCH_SERVE, {cfg.n_kv_heads, cfg.n_heads})
    abstract = _named(r_nn.abstract_tree(desc))
    cshapes = _named(cdesc)
    return runs, ({k: _pad(v.spec, len(abstract[k].shape)) for k, v in _named(pspec).items()},
                  {k: _pad(v.spec, len(cshapes[k].shape)) for k, v in _named(cspec).items()})


def _r_train(arch, rules, dtype, flat, mesh):
    """The reference's loss and gradients of the first batch and its
    chained compressed steps, under `activate(mesh, rules)` when given."""
    cfg = _r_cfg(arch, n_layers=LAYERS, dtype=dtype)
    model = r_build_model(cfg)
    rules = getattr(r_sh, rules)
    params = _placed(flat, model.desc(), rules, mesh)
    gc = RGradCompressConfig(eb_rel=EB_REL)
    step = r_steps.make_train_step(model, RAdamWConfig(**OPT), gc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    batches = [{k: jnp.asarray(v) for k, v in W.train_batch(cfg, dcfg, s).items()}
               for s in range(STEPS)]

    def both(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(params, batch)
        return loss, grads, step(params, opt, batch)

    rule_specs = None if mesh is None else {
        k: _pad(v.spec, len(a.shape)) for (k, v), a in zip(
            _named(r_sh.tree_shardings(r_nn.axes_tree(model.desc()), rules, mesh,
                                       r_nn.abstract_tree(model.desc()))).items(),
            _named(r_nn.abstract_tree(model.desc())).values())}

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
                    m=_host(opt["adam"]["m"]), v=_host(opt["adam"]["v"]), specs=specs,
                    rules=rule_specs)

    if mesh is None:
        return body()
    with r_sh.activate(mesh, rules):
        return body()


def _p_train_unsharded(arch, flat) -> dict:
    """The port's unsharded chained compressed steps (float32) on the same
    weights and batches: the params and Adam's m and v after the last."""
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), n_layers=LAYERS,
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = W.nest({k: torch.from_numpy(v.copy()) for k, v in flat.items()})
    gc = GradCompressConfig(eb_rel=EB_REL)
    step = steps.make_train_step(model, AdamWConfig(**OPT), gc)
    opt = steps.init_opt_state(params, gc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    for s in range(STEPS):
        params, opt, _ = step(params, opt, {k: torch.from_numpy(v) for k, v in
                                            W.train_batch(cfg, dcfg, s).items()})
    return {part: {k: v.numpy() for k, v in W._flat(tree).items()}
            for part, tree in (("params", params), ("m", opt["adam"]["m"]),
                               ("v", opt["adam"]["v"]))}


# -- the jobs -------------------------------------------------------------------


def scenario_reference_train(spec: dict, rank: int) -> dict:
    """The reference's training cases (`_r_train`) on the weights in
    `args["dir"]`, pickled to `reference_train.pkl` in the job's outdir."""
    devices = jax.devices()
    if len(devices) < 8:
        raise RuntimeError(f"{len(devices)} devices: XLA_FLAGS must ask for 8")
    wd = spec["args"]["dir"]
    out = {}
    for shape, (arch, rules, dtype) in TRAIN:
        flat = dict(np.load(os.path.join(wd, f"train-{arch}.npz")))
        out[shape, (arch, rules, dtype)] = _r_train(arch, rules, dtype, flat,
                                                    _r_mesh(devices, shape))
    with open(os.path.join(spec["outdir"], "reference_train.pkl"), "wb") as f:
        pickle.dump(out, f)
    return {"devices": len(devices)}


def _reference_train_job(wd) -> dict:
    """`scenario_reference_train` as a one-process job of this file."""
    from repro_torch.launch import mhrun

    res = mhrun.run([sys.executable, os.path.abspath(__file__)], 1,
                    scenario="reference_train", args={"dir": str(wd)}, timeout_s=900,
                    workdir=str(wd / "job"),
                    extra_env={"PYTHONPATH": os.pathsep.join(
                        p for p in (os.path.join(os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__))), "src"), os.environ.get("PYTHONPATH"))
                        if p)})
    mhrun.require_success(res)
    with open(wd / "job" / "reference_train.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(tmp_path_factory, emulated_devices):
    """Both meshes' jobs, one after the other in a thread (eight ranks at
    once would starve the reference's compiles) while the reference runs
    here."""
    weights = _weights()
    teacher = np.random.default_rng(3).integers(1, 512, (BATCH_SERVE, GEN - 1)).astype(np.int32)
    dirs = {shape: tmp_path_factory.mktemp(f"mesh_families_{shape[0]}x{shape[1]}")
            for shape in MESHES}
    jobs, errors = {}, []

    def run(shape):
        wd = dirs[shape]
        for name, flat in weights.items():
            np.savez(wd / name, **flat)
        np.save(wd / "teacher.npy", teacher)
        serve_args = dict(mesh=list(shape), cases=[c for sh, c in SERVED if sh == shape],
                          prompt_len=PROMPT, gen=GEN)
        train_args = dict(mesh=list(shape), cases=TRAIN_CASES[shape], layers=LAYERS, seq=SEQ,
                          batch=BATCH, steps=STEPS, eb_rel=EB_REL, opt=OPT,
                          weights_file="train-{arch}.npz")
        try:
            payloads = W.run_job("mesh_families", 4, wd, timeout_s=900, args=dict(
                serve=serve_args, train=train_args, init_cache=INIT_CACHE),
                env={"OMP_WAIT_POLICY": "PASSIVE"})
        except AssertionError as e:  # reported below, in the test's thread
            errors.append(e)
            return
        with open(wd / "mesh_serve.pkl", "rb") as f:
            served = pickle.load(f)
        with open(wd / "mesh_train.pkl", "rb") as f:
            trained = pickle.load(f)
        jobs[shape] = (payloads, served, trained)

    ref = {}
    ref_dir = tmp_path_factory.mktemp("mesh_families_reference")
    for name, flat in weights.items():
        np.savez(ref_dir / name, **flat)

    def reference_train():
        try:
            ref.update(_reference_train_job(ref_dir))
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=lambda: [run(s) for s in MESHES]),
               threading.Thread(target=reference_train)]
    for t in threads:
        t.start()
    for arch, dtype, _ in SERVE_CASES:
        flat = weights[f"weights-{arch}.npz"]
        if dtype == "bfloat16":
            ref[None, (arch, dtype)] = _r_serve(arch, dtype, flat, teacher, None)
        for shape in SERVE_MESHES[dtype]:
            ref[shape, (arch, dtype)] = _r_serve(arch, dtype, flat, teacher,
                                                 _r_mesh(emulated_devices, shape))
    for t in threads:
        t.join(1800)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    # after the jobs: torch's threads here would contend with the ranks'
    for _, (arch, _, _) in TRAIN:
        ref["port", arch] = _p_train_unsharded(arch, weights[f"train-{arch}.npz"])
    return jobs, ref, weights, teacher


def _key(case) -> str:
    return "/".join(str(c) for c in case)


def _serve_bound(ref, arch) -> float:
    """max(2e-2, d), for the hybrid and xLSTM max(2e-2, 2d): d the larger of
    the reference's own sharded-vs-unsharded bfloat16 distance and its own
    bfloat16-vs-float32 distance under the mesh, over the steps."""
    d = max(_rel(s, w) for shape in SERVE_MESHES["bfloat16"]
            for other in ((None, (arch, "bfloat16")), (shape, (arch, "float32")))
            for s, w in zip(ref[shape, (arch, "bfloat16")][0], ref[other][0]))
    return max(BF16_FLOOR, 2 * d if arch in RECURRENT else d)


def _sid(c) -> str:
    return f"{c[0].split('-')[0]}-{c[1]}"


def _served_id(c) -> str:
    shape, case = c
    return f"{shape[0]}x{shape[1]}-{_sid(case)}"


@pytest.mark.parametrize("shape,case", SERVED, ids=[_served_id(c) for c in SERVED])
def test_served_logits_match_reference(results, shape, case):
    jobs, ref = results[:2]
    got = jobs[shape][1][_key(case)]
    steps, _ = ref[shape, case[:2]]
    assert len(got["logits"]) == len(steps) == GEN
    bound = DECODE_F32 if case[1] == "float32" else _serve_bound(ref, case[0])
    for i, (g, w) in enumerate(zip(got["logits"], steps)):
        assert _rel(g, w) <= bound, (i, _rel(g, w), bound)


#: the cache leaves that take 'model' on each mesh (the rest split by batch only)
MODEL_SPLIT = {
    VISION: {"blocks/k", "blocks/v"},
    ENCDEC: {"blocks/k", "blocks/v"},
    HYBRID: {"attn/k", "attn/v"},
    XLSTM: {"groups/m/C", "groups/m/n", "groups/m/m", "groups/s/c", "groups/s/n", "groups/s/m",
            "groups/s/h"},
}


@pytest.mark.parametrize("shape,case", SERVED, ids=[_served_id(c) for c in SERVED])
def test_served_placements_match_reference(results, shape, case):
    jobs, ref = results[:2]
    got = jobs[shape][1][_key(case)]
    pspec, cspec = ref[shape, case[:2]][1]
    lists = {k: [list(e) if isinstance(e, tuple) else e for e in v] for k, v in pspec.items()}
    assert got["param_specs"] == lists
    assert got["cache_specs"] == {k: [list(e) if isinstance(e, tuple) else e for e in v]
                                  for k, v in cspec.items()}
    split = {k for k, v in got["cache_specs"].items() if "model" in v}
    want = MODEL_SPLIT[case[0]] - ({"blocks/k", "blocks/v"} if case[0] == VISION and shape == (1, 4)
                                   else set())  # internvl2's 2 KV heads do not divide 4
    assert split == want, (split, want)


_UNSHARDED: dict = {}


def _unsharded(results, case) -> dict:
    """The port's unsharded `run_static` of a serve case (run once)."""
    if case not in _UNSHARDED:
        _, _, weights, teacher = results
        arch, dtype, batch = case
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype=dtype)
        params = W.nest({k: torch.from_numpy(v) for k, v in weights[f"weights-{arch}.npz"].items()})
        args = argparse.Namespace(batch=batch, prompt_len=PROMPT, gen=GEN, sample=False)
        _UNSHARDED[case] = serve.run_static(args, cfg, build_model(cfg, device="cpu"), params,
                                            teacher=teacher[:batch], keep=True)
    return _UNSHARDED[case]


@pytest.mark.parametrize("shape,case", SERVED, ids=[_served_id(c) for c in SERVED])
def test_served_cache_and_tokens_match_unsharded(results, shape, case):
    """The gathered cache (recurrent states, conv windows, the memory, K/V)
    against the port's unsharded run (the bounds of
    tests/test_torch_mesh.py), and every rank holding the same tokens."""
    jobs, ref = results[:2]
    arch, dtype, _ = case
    res = _unsharded(results, case)
    got = jobs[shape][1][_key(case)]
    bound = DECODE_F32 if dtype == "float32" else _serve_bound(ref, arch)
    for k, v in W._flat(res["cache"]).items():
        want = v.to(torch.float32).numpy()
        if k == "pos":
            assert np.array_equal(got["cache"][k], want)
        elif dtype == "float32":
            np.testing.assert_allclose(got["cache"][k], want, rtol=BF16_ULP,
                                       atol=DECODE_F32 * float(np.abs(want).max()), err_msg=k)
        else:
            assert _rel(got["cache"][k], want) <= bound, k
    for g, w in zip(got["logits"], res["logits"]):
        assert _rel(g, w.numpy()) <= bound
    payloads = jobs[shape][0]
    for p in payloads[1:]:
        assert p["tokens"][_key(case)] == payloads[0]["tokens"][_key(case)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mamba_gathers_its_fused_projection(results, shape):
    """zamba2's `in_proj` output (560 columns, split at 280 or 140 inside
    x) is gathered along its columns over 'model' once a Mamba layer a
    call, and its SSD state once more where the cache keeps it whole."""
    served = results[0][shape][1]
    gathers = served[_key((HYBRID, "float32", BATCH_SERVE))]["gathers"]
    fused = [g for g in gathers if g[0] == "model" and g[1][-1] == 560 // shape[1] and g[2] == 2]
    calls, mamba = GEN, 5  # the prefill and 7 steps, 5 Mamba layers
    assert len(fused) == calls * mamba, gathers
    state = [g for g in gathers if g[0] == "model" and len(g[1]) == 4 and g[2] == 1]
    assert len(state) == calls * mamba


# -- training ---------------------------------------------------------------------


def _tid(c) -> str:
    shape, (arch, rules, dtype) = c
    return f"{shape[0]}x{shape[1]}-{arch.split('-')[0]}-{rules}-{dtype}"


def _got(results, shape, case) -> dict:
    return results[0][shape][2]["cases"][_key(case)]


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_loss_and_grads_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert got["tokens"] == BATCH * SEQ
    assert sorted(got["grads"]) == sorted(want["grads"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k, w in want["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL * float(np.abs(w).max()),
                                   err_msg=k)


def _split(spec, shape) -> list:
    """`spec` without the mesh dims of size 1 (the reference's compiled
    step drops them from its specs)."""
    sizes = dict(zip(("data", "model"), shape))
    out = []
    for e in spec:
        names = [n for n in ([e] if isinstance(e, str) else e or []) if sizes[n] > 1]
        out.append(None if not names else names[0] if len(names) == 1 else names)
    return out


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_placements_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert sorted(got["specs"]) == sorted(want["specs"])
    relaid = set()
    for k, spec in got["specs"].items():
        rule = want["rules"][k.split("/", 1)[1]]
        if _split(want["specs"][k], shape) != _split(rule, shape):
            relaid.add(k)  # GSPMD's choice after the step: the port keeps the rules'
            assert _split(spec, shape) == _split(rule, shape), k
        else:
            assert _split(spec, shape) == _split(want["specs"][k], shape), k
    assert all(k.endswith(RELAID) for k in relaid), sorted(relaid)
    for k, spec in got["grad_specs"].items():
        assert spec == got["specs"][f"params/{k}"], k
    if case[0] == HYBRID:  # the fused projection's columns over 'model'
        fsdp = "data" if case[1] == "TRAIN_RULES" else None
        assert got["specs"]["params/mamba_groups/in_proj"] == [None, None, fsdp, "model"]
        assert got["specs"]["params/fuse"] == [fsdp, None]  # 'data' once, on its first dim


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_backward_plans_no_collective_of_dtensors_own_but_all_reduce(results, shape, case):
    comm = _got(results, shape, case)["comm"]
    assert set(comm) <= ALLOWED_COLLECTIVES, comm
    assert comm["c10d_functional.all_reduce"] > 0
    # FSDP's gathered weights, and internvl2's 2 KV heads gathered over 4
    # ranks (`nn.split_heads`), give their gradients back as reduce-scatters
    fsdp = case[1] == "TRAIN_RULES" and shape == (2, 2)
    gathered_heads = case[0] == VISION and shape == (1, 4)
    assert (comm.get("c10d._reduce_scatter_base_", 0) > 0) == (fsdp or gathered_heads), comm


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_chained_compressed_steps_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert got["step"] == STEPS and len(got["metrics"]) == STEPS
    lr_sum = 0.0
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert sorted(g) == sorted(w)
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        lr_sum += w["lr"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL, err_msg=str(i))
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(g["wire_bits_per_value"], w["wire_bits_per_value"],
                                   rtol=1e-3, err_msg=str(i))
    unsharded = results[1]["port", case[0]]
    for part in ("params", "m", "v"):
        for k, w in want[part].items():
            g = got[part][k]
            err, scale = np.abs(g - w), float(np.abs(w).max())
            tol = F32_ATOL * scale + (2 * F32_RTOL * lr_sum if part == "params" else 0.0)
            off = int((err > tol).sum())
            allowed = max(FLIP_SHARE * err.size, ADAM_OUTLIERS)
            if part != "params":  # as many as the port's unsharded run has, and the share
                allowed += int((np.abs(unsharded[part][k] - w) > tol).sum())
            assert off <= allowed, (part, k, off, allowed)
            most = 2 * lr_sum if part == "params" else FLIPPED_STATE * scale
            assert float(err.max()) <= tol + most, (part, k, float(err.max()))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_rank_reports_the_same_losses(results, shape):
    payloads = results[0][shape][0]
    for p in payloads[1:]:
        assert p["losses"] == payloads[0]["losses"]
    assert payloads[0]["backend"] == "gloo"


# -- layouts ----------------------------------------------------------------------------


#: (arch, mesh, batch, max_len): the recurrent and memory caches under the
#: size matching, and batches as long as a stack or a head count
LAYOUT_CASES = {
    f"{a.split('-')[0]}-b{b}-{s[0]}x{s[1]}": (a, s, b, m)
    for a in ARCHS for s in MESHES for b, m in ((BATCH_SERVE, PROMPT + GEN), (4, 8), (2, 8))
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_cache_layout_matches_reference(emulated_devices, name):
    arch, shape, batch, max_len = LAYOUT_CASES[name]
    rcfg = _r_cfg(arch)
    desc = r_build_model(rcfg).cache_desc(batch, max_len)
    want = r_sh.cache_sharding(desc, _r_mesh(emulated_devices, shape), batch,
                               {rcfg.n_kv_heads, rcfg.n_heads})
    pcfg = reduced_for_smoke(get_config(arch))
    got = rsh.cache_sharding(build_model(pcfg, device="cpu").cache_desc(batch, max_len),
                             _stand_in(shape), batch, {pcfg.n_kv_heads, pcfg.n_heads})
    shapes = _named(desc)
    assert sorted(W._flat(got)) == sorted(shapes)
    for k, w in _named(want).items():
        node = W._flat(got)[k]
        spec = rsh.placements_to_spec(node.mesh, node.placements, len(shapes[k].shape))
        assert _pad(spec, len(shapes[k].shape)) == _pad(w.spec, len(shapes[k].shape)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_lays_its_cache_out_under_a_mesh(results, emulated_devices, arch):
    """`init_cache` under `activate` returns DTensors for every leaf, laid
    out as the reference's `cache_sharding` lays them out, on both meshes
    (no family raises under a mesh any more)."""
    rcfg = _r_cfg(arch)
    for shape in MESHES:
        got = results[0][shape][0][0]["init_cache"][arch]
        desc = r_build_model(rcfg).cache_desc(BATCH_SERVE, PROMPT + GEN)
        want = r_sh.cache_sharding(desc, _r_mesh(emulated_devices, shape), BATCH_SERVE,
                                   {rcfg.n_kv_heads, rcfg.n_heads})
        shapes = _named(desc)
        assert sorted(got) == sorted(shapes)
        for k, w in _named(want).items():
            assert got[k] is not None, k
            assert _pad(got[k], len(shapes[k].shape)) == _pad(w.spec, len(shapes[k].shape)), k


def test_paged_pool_under_a_mesh_says_the_reference_never_runs_it():
    """The paged KV pool still raises under a mesh, now saying why: the
    reference's `run_continuous` returns before it makes a mesh."""
    from repro_torch.models import nn as pnn

    q = types.SimpleNamespace()
    with pytest.raises(NotImplementedError, match="reference never runs"):
        pnn._attention_sharded(q, None, None, True, torch.zeros(2, dtype=torch.int32), None,
                               None, None)


if __name__ == "__main__":  # a rank of `_reference_train_job`
    from repro_torch.launch import mhrun

    sys.exit(mhrun.worker_main(sys.argv[-1], {"reference_train": scenario_reference_train}))
