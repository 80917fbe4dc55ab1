"""The MoE and MLA decoders under a mesh on the port (`blocks.apply_moe` and
`blocks.apply_mla` on DTensors, the `dense_blocks` stack) against the
reference under its `activate`.

The port runs as two 4-rank gloo jobs (`repro_torch.launch.mhrun`, rank
code `tests/torch_shard_worker.py::scenario_mesh_moe`), one on a (2, 2)
and one on a (1, 4) ('data', 'model') mesh. The reference runs in this
process on an `AxisType.Auto` mesh of four of the eight emulated devices
(its `jax.make_mesh` meshes are Explicit, where its constraint fails:
ROADMAP.md §C), params placed by its `tree_shardings`. The models are the
reduced llama4-scout-17b-a16e (GQA with 4 query and 2 KV heads, top-1 of 8
experts and a shared expert) and deepseek-v2-236b (MLA, top-2 of 8
experts, shared experts, one leading layer in `dense_blocks`); their
weights are drawn once from numpy by the reference's descriptors and
carried to both packages.

* Serving under `SERVE_RULES` (`launch.serve.run_static(mesh=)`): both
  models at float32 and bfloat16, batch 8, a prefill of 16 tokens and 4
  teacher-forced decode steps (`max_len` 21 is no head count, so no cache
  meets the size-matching quirks below by accident), and llama4 at batch
  4, where its 4-layer cache stack takes the batch's split; at float32
  also the forward without a cache. No expert weight is gathered on the
  way.
* Capacity: one MoE block of each model under `SERVE_RULES` on a batch on
  which the reference drops tokens (capacity factor 0.5); the sharded
  port keeps and drops exactly the reference's choices, with the dispatch
  group spanning the data split (its choices gathered) and, for llama4,
  two groups that each rank of the data split holds whole.
* Training: `TRAIN_RULES` on both meshes and `TRAIN_RULES_TP` on (2, 2),
  2 layers (deepseek: the dense layer and one MoE layer), batch 4 of 32
  tokens: the loss and every gradient and its placement against the
  reference's step, three chained compressed steps, the collectives
  DTensor plans itself, and `launch.train.run(mesh=)` for deepseek.
* Layouts: `cache_sharding` of these caches against the reference's, and
  deepseek's decode into a latent cache split along its sequence (its
  `max_len` 4 is a head count) against the reference's.

Tolerances are those of tests/test_torch_mesh.py (serving) and
tests/test_torch_mesh_train.py (training), with two more rules from
tests/test_torch_train_families.py: the router of a top-1 MoE has a
gradient that is zero but for rounding (its renormalized gate w / w is 1),
held to |g| <= 1e-6 of the model's largest gradient on both sides; and at
bfloat16 the routed experts' weights and the router get 2d, d the
reference's own sharded-vs-unsharded distance (a router logit an ulp
apart sends a token to another expert; each side has such flips of its
own, ROADMAP.md §C). The capacity blocks run at float32, where the
routing is exact (tests/test_torch_moe.py): a token sent elsewhere or
dropped would move its output by O(max|y|).
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
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import blocks as r_blocks
from repro.models import build_model as r_build_model
from repro.models import nn as r_nn
from repro.models import reduced_for_smoke as r_reduced
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import GradCompressConfig as RGradCompressConfig
from repro.runtime import sharding as r_sh
from repro.runtime import steps as r_steps
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.runtime import sharding as rsh

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
ARCHS = [LLAMA4, DEEPSEEK]
MESHES = [(2, 2), (1, 4)]
PROMPT, GEN = 16, 5
SERVE_CASES = [(a, d, 8) for a in ARCHS for d in ("float32", "bfloat16")] + [(LLAMA4, "float32", 4)]
TRAIN_CASES = {
    (2, 2): [(DEEPSEEK, "TRAIN_RULES", "float32"), (DEEPSEEK, "TRAIN_RULES", "bfloat16"),
             (LLAMA4, "TRAIN_RULES_TP", "bfloat16")],
    (1, 4): [(LLAMA4, "TRAIN_RULES", "float32")],
}
TRAIN = [(shape, case) for shape, cases in TRAIN_CASES.items() for case in cases]
#: MoE blocks on which the reference drops tokens at capacity: (name, arch,
#: MoE fields, x's (batch, length))
MOE_BLOCKS = [
    dict(name="deepseek-one-group", arch=DEEPSEEK, moe=dict(capacity_factor=0.5), shape=[4, 16]),
    dict(name="llama4-two-groups", arch=LLAMA4, moe=dict(capacity_factor=0.5, dispatch_groups=2),
         shape=[4, 16]),
]
LAYERS, SEQ, BATCH, STEPS, EB_REL = 2, 32, 4, 3, 1e-3
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=5)
#: deepseek's launcher on (2, 2): 2 compressed steps (an async save at
#: step 2, the final save), then a resume to step 3, on the mesh and unsharded
LAUNCH = ["--arch", DEEPSEEK, "--device", "cpu", "--smoke", "--n-layers", "2", "--seq", "32",
          "--batch", "4", "--lr", "1e-3", "--log-every", "100", "--steps", "2", "--ckpt-every",
          "2", "--compress-grads"]
RESUME_STEPS = 3
#: deepseek's decode into a latent cache of `max_len` 4, a head count: its
#: sequence takes 'model' by size matching (a prefill of 2, one decode step)
LATENT = dict(name="deepseek-latent-b2", arch=DEEPSEEK, dtype="float32", batch=2, prompt_len=2,
              gen=2, variant="baseline", weights="weights-{arch}.npz")
FORWARD_F32, DECODE_F32, BF16_FLOOR = 1e-5, 1e-3, 2e-2
BF16_ULP = 2.0 ** -7
LOSS_RTOL, F32_ATOL, F32_RTOL = 1e-5, 1e-5, 1e-4
FLIP_SHARE, FLIPPED_STATE = 5e-3, 1e-2
ZERO_GRAD = 1e-6
MOE_F32_RTOL, MOE_F32_ATOL = 1e-4, 1e-5
ROUTED = ("mlp/router", "mlp/w_gate", "mlp/w_up", "mlp/w_down")
ALLOWED_COLLECTIVES = {"c10d_functional.all_reduce", "c10d.allgather_",
                       "c10d._reduce_scatter_base_", "c10d.allreduce_"}


def _r_mesh(devices, shape):
    return Mesh(np.array(devices[: int(np.prod(shape))]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * len(shape))


def _stand_in(shape):
    """What `cache_sharding` and the guard read of a mesh: its dim names and
    shape (no process group in this process)."""
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


def _r_block_cfg(case):
    cfg = _r_cfg(case["arch"], dtype="float32")
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, **case["moe"]))


def _weights():
    """{file name: flat weights}: each model's serving and training weights
    and each capacity block's."""
    out = {}
    for arch in ARCHS:
        out[f"weights-{arch}.npz"] = _draw(r_build_model(_r_cfg(arch)).desc())
        out[f"train-{arch}.npz"] = _draw(r_build_model(_r_cfg(arch, n_layers=LAYERS)).desc(), 1)
    for case in MOE_BLOCKS:
        out[f"moe-{case['name']}.npz"] = _draw(r_blocks.desc_moe(_r_block_cfg(case)), 2)
    return out


# -- the reference ------------------------------------------------------------


def _placed(flat, model_desc, rules, mesh):
    params = W.nest({k: jnp.asarray(v) for k, v in flat.items()})
    if mesh is None:
        return params
    shard = r_sh.tree_shardings(r_nn.axes_tree(model_desc), rules, mesh,
                                r_nn.abstract_tree(model_desc))
    return jax.tree_util.tree_map(jax.device_put, params, shard)


def _r_serve(arch, dtype, batch, flat, teacher, mesh, prompt=PROMPT, gen=GEN, forward=True):
    """The reference's prefill and teacher-forced decode steps and (with
    `forward`) its forward without a cache (last-position logits per step,
    the forward's logits), and under a mesh the param and cache specs."""
    cfg = _r_cfg(arch, dtype=dtype)
    model = r_build_model(cfg)
    params = _placed(flat, model.desc(), r_sh.SERVE_RULES, mesh)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (batch, prompt)).astype(np.int32)
    prefill = jax.jit(r_steps.make_prefill_step(model))
    decode = jax.jit(lambda p, t, c: model.forward(p, {"tokens": t}, cache=c))
    uncached = jax.jit(lambda p, t: model.forward(p, {"tokens": t})[0])

    def body():
        cache = model.init_cache(batch, prompt + gen)
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        out = [np.asarray(logits[:, -1], np.float32)]
        for i in range(gen - 1):
            lg, cache = decode(params, teacher[:batch, i:i + 1], cache)
            out.append(np.asarray(lg[:, -1], np.float32))
        # the forward without a cache is held at float32 only
        whole = uncached(params, prompts) if dtype == "float32" and forward else None
        return out, None if whole is None else np.asarray(whole, np.float32)

    if mesh is None:
        return body(), None
    with r_sh.activate(mesh, r_sh.SERVE_RULES):
        runs = body()
    desc, cdesc = model.desc(), model.cache_desc(batch, prompt + gen)
    pspec = r_sh.tree_shardings(r_nn.axes_tree(desc), r_sh.SERVE_RULES, mesh, r_nn.abstract_tree(desc))
    cspec = r_sh.cache_sharding(cdesc, mesh, batch, {cfg.n_kv_heads, cfg.n_heads})
    abstract = _named(r_nn.abstract_tree(desc))
    cshapes = _named(cdesc)
    return runs, ({k: _pad(v.spec, len(abstract[k].shape)) for k, v in _named(pspec).items()},
                  {k: _pad(v.spec, len(cshapes[k].shape)) for k, v in _named(cspec).items()})


def _r_keep(params, x, cfg):
    """The reference's expert choices and kept flags of `apply_moe`'s
    routing (its lines, `repro/models/blocks.py`), token order."""
    b, l, d = x.shape
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    n = b * l
    g_ = mo.dispatch_groups if n % max(mo.dispatch_groups, 1) == 0 else 1
    ng = n // g_
    xn = r_nn.rms_norm(x, params["norm"], cfg.norm_eps).reshape(g_, ng, d)
    probs = jax.nn.softmax(r_nn.dense(xn, params["router"]).astype(jnp.float32), axis=-1)
    _, sel = jax.lax.top_k(probs, k)
    cap = min(max(int(mo.capacity_factor * ng * k / e), 8), ng)
    flat_e = sel.reshape(g_, ng * k)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=-1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(e)))(se)
    rank = jnp.arange(ng * k)[None] - jnp.take_along_axis(starts, se, axis=-1)
    back = jnp.zeros_like(rank).at[jnp.arange(g_)[:, None], order].set(rank)
    return np.asarray(sel).reshape(b, l, k), np.asarray(back < cap).reshape(b, l, k)


def _r_block(case, flat, mesh):
    cfg = _r_block_cfg(case)
    params = W.nest({k: jnp.asarray(v) for k, v in flat.items()})
    x = np.random.default_rng(5).standard_normal(tuple(case["shape"]) + (cfg.d_model,))
    x = jnp.asarray(x, jnp.float32)
    desc = r_blocks.desc_moe(cfg)
    shard = r_sh.tree_shardings(r_nn.axes_tree(desc), r_sh.SERVE_RULES, mesh, r_nn.abstract_tree(desc))
    with r_sh.activate(mesh, r_sh.SERVE_RULES):
        y = jax.jit(lambda p, x: r_blocks.apply_moe(p, x, cfg))(
            jax.tree_util.tree_map(jax.device_put, params, shard), x)
    sel, keep = _r_keep(params, x, cfg)
    return np.asarray(y, np.float32), sel, keep


def _r_train(arch, rules, dtype, flat, batches, mesh):
    """The reference's loss and gradients of the first batch and its
    chained compressed steps, under `activate(mesh, rules)` when given."""
    model = r_build_model(_r_cfg(arch, n_layers=LAYERS, dtype=dtype))
    rules = getattr(r_sh, rules)
    params = _placed(flat, model.desc(), rules, mesh)
    gc = RGradCompressConfig(eb_rel=EB_REL)
    step = r_steps.make_train_step(model, RAdamWConfig(**OPT), gc)

    def both(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(params, batch)
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


# -- the jobs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory, emulated_devices):
    """Both meshes' jobs, run in threads while the reference runs here."""
    weights = _weights()
    teacher = np.random.default_rng(3).integers(1, 512, (8, GEN - 1)).astype(np.int32)
    dirs = {shape: tmp_path_factory.mktemp(f"mesh_moe_{shape[0]}x{shape[1]}") for shape in MESHES}
    jobs, errors = {}, []

    def run(shape):
        wd = dirs[shape]
        for name, flat in weights.items():
            np.savez(wd / name, **flat)
        np.save(wd / "teacher.npy", teacher)
        serve_args = dict(mesh=list(shape), cases=SERVE_CASES + [LATENT], prompt_len=PROMPT,
                          gen=GEN, moe_blocks=MOE_BLOCKS)
        train_args = dict(mesh=list(shape), cases=TRAIN_CASES[shape], layers=LAYERS, seq=SEQ,
                          batch=BATCH, steps=STEPS, eb_rel=EB_REL, opt=OPT,
                          weights_file="train-{arch}.npz",
                          launcher=dict(argv=LAUNCH, resume_steps=RESUME_STEPS)
                          if shape == (2, 2) else None)
        try:
            payloads = W.run_job("mesh_moe", 4, wd, timeout_s=900, args=dict(
                serve=serve_args, train=train_args))
        except AssertionError as e:  # reported below, in the test's thread
            errors.append(e)
            return
        with open(wd / "mesh_serve.pkl", "rb") as f:
            served = pickle.load(f)
        with open(wd / "mesh_train.pkl", "rb") as f:
            trained = pickle.load(f)
        jobs[shape] = (payloads, served, trained)

    threads = [threading.Thread(target=run, args=(s,)) for s in MESHES]
    for t in threads:
        t.start()
    ref = {}
    for arch, dtype, batch in SERVE_CASES:
        flat = weights[f"weights-{arch}.npz"]
        if dtype == "bfloat16":
            ref[None, (arch, dtype, batch)] = _r_serve(arch, dtype, batch, flat, teacher, None)
        for shape in MESHES:
            ref[shape, (arch, dtype, batch)] = _r_serve(
                arch, dtype, batch, flat, teacher, _r_mesh(emulated_devices, shape))
    for shape in MESHES:
        ref[shape, LATENT["name"]] = _r_serve(
            DEEPSEEK, LATENT["dtype"], LATENT["batch"], weights[f"weights-{DEEPSEEK}.npz"],
            teacher, _r_mesh(emulated_devices, shape), LATENT["prompt_len"], LATENT["gen"],
            forward=False)
    for case in MOE_BLOCKS:
        for shape in MESHES:
            ref[shape, case["name"]] = _r_block(case, weights[f"moe-{case['name']}.npz"],
                                                _r_mesh(emulated_devices, shape))
    dcfg = RDataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH)
    batches = [{k: jnp.asarray(v) for k, v in r_synthetic_batch(dcfg, s).items()}
               for s in range(STEPS)]
    for shape, (arch, rules, dtype) in TRAIN:
        flat = weights[f"train-{arch}.npz"]
        ref[shape, (arch, rules, dtype)] = _r_train(arch, rules, dtype, flat, batches,
                                                    _r_mesh(emulated_devices, shape))
        if dtype == "bfloat16" and (None, arch, dtype) not in ref:
            ref[None, arch, dtype] = _r_train(arch, rules, dtype, flat, batches, None)
    wd = tmp_path_factory.mktemp("mesh_moe_unsharded")
    first = train.main(LAUNCH + ["--ckpt-dir", str(wd)])
    again = train.main(LAUNCH + ["--ckpt-dir", str(wd), "--steps", str(RESUME_STEPS), "--resume"])
    for t in threads:
        t.join(960)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return jobs, ref, weights, teacher, (first["losses"], again["losses"])


def _key(case) -> str:
    return "/".join(str(c) for c in case)


def _serve_bound(ref, arch, batch) -> float:
    """max(2e-2, d): d the reference's own sharded-vs-unsharded bfloat16
    distance over the steps, on either mesh."""
    d = max(_rel(s, u) for shape in MESHES
            for s, u in zip(ref[shape, (arch, "bfloat16", batch)][0][0],
                            ref[None, (arch, "bfloat16", batch)][0][0]))
    return max(BF16_FLOOR, d)


def _sid(c) -> str:
    return f"{c[0].split('-')[0]}-{c[1]}-b{c[2]}"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", SERVE_CASES, ids=_sid)
def test_served_logits_match_reference(results, shape, case):
    jobs, ref = results[:2]
    got = jobs[shape][1][_key(case)]
    (steps, forward), _ = ref[shape, case]
    assert len(got["logits"]) == len(steps) == GEN
    if case[1] == "float32":
        assert _rel(got["forward"], forward) <= FORWARD_F32
        bound = DECODE_F32
    else:
        bound = _serve_bound(ref, case[0], case[2])
    for i, (g, w) in enumerate(zip(got["logits"], steps)):
        assert _rel(g, w) <= bound, (i, _rel(g, w), bound)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", SERVE_CASES, ids=_sid)
def test_served_placements_match_reference(results, shape, case):
    jobs, ref = results[:2]
    got = jobs[shape][1][_key(case)]
    pspec, cspec = ref[shape, case][1]
    lists = {k: [list(e) if isinstance(e, tuple) else e for e in v] for k, v in pspec.items()}
    assert got["param_specs"] == lists
    assert got["cache_specs"] == {k: [list(e) if isinstance(e, tuple) else e for e in v]
                                  for k, v in cspec.items()}
    assert got["param_specs"]["blocks/mlp/w_gate"] == [None, "model", None, None]
    if case[0] == DEEPSEEK:  # the latent has no head dim: whole over 'model'
        assert got["cache_specs"]["blocks/ckv"] == [None, "data", None, None]
        assert got["param_specs"]["dense_blocks/attn/wkv_b"] == [None, None, "model"]
    if case[2] == 4:  # the 4-layer stack is as long as the batch: it takes the data split
        assert got["cache_specs"]["blocks/k"][:2] == ["data", "model"]


_UNSHARDED: dict = {}


def _unsharded(results, case) -> dict:
    """The port's unsharded `run_static` of a serve case (run once)."""
    if case not in _UNSHARDED:
        _, _, weights, teacher, _ = results
        arch, dtype, batch = case
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype=dtype)
        params = W.nest({k: torch.from_numpy(v) for k, v in weights[f"weights-{arch}.npz"].items()})
        args = argparse.Namespace(batch=batch, prompt_len=PROMPT, gen=GEN, sample=False)
        _UNSHARDED[case] = serve.run_static(args, cfg, build_model(cfg, device="cpu"), params,
                                            teacher=teacher[:batch], keep=True)
    return _UNSHARDED[case]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", SERVE_CASES, ids=_sid)
def test_served_cache_and_tokens_match_unsharded(results, shape, case):
    """The gathered cache against the port's unsharded run (the bounds of
    tests/test_torch_mesh.py), and every rank holding the same tokens."""
    jobs, ref = results[:2]
    arch, dtype, batch = case
    res = _unsharded(results, case)
    got = jobs[shape][1][_key(case)]
    bound = DECODE_F32 if dtype == "float32" else _serve_bound(ref, arch, batch)
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
def test_no_expert_weight_is_gathered_over_model_when_serving(results, shape):
    """The serve path's host-staged gathers: none over 'model' of a tensor
    of three or more dims with an expert weight's shape (only a split
    activation's heads or vocab may be gathered there), and no 3-D weight
    shard gathered at all."""
    jobs = results[0]
    served = jobs[shape][1]
    cfgs = {a: reduced_for_smoke(get_config(a)) for a in ARCHS}
    for case in SERVE_CASES:
        mo = cfgs[case[0]].moe
        expert = {(mo.n_experts // shape[1], cfgs[case[0]].d_model, mo.d_ff_expert),
                  (mo.n_experts // shape[1], mo.d_ff_expert, cfgs[case[0]].d_model)}
        for dim, local, _ in served[_key(case)]["gathers"]:
            assert tuple(local[-3:]) not in expert, (case, dim, local)
    for name, block in served["moe_blocks"].items():
        assert all(dim != "model" for dim, _, _ in block["gathers"]), (name, block["gathers"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", [c["name"] for c in MOE_BLOCKS])
def test_capacity_drops_the_reference_tokens(results, shape, name):
    jobs, ref = results[:2]
    got = jobs[shape][1]["moe_blocks"][name]
    y, sel, keep = ref[shape, name]
    assert int((~keep).sum()) > 0  # the reference drops tokens on this batch
    np.testing.assert_array_equal(got["sel"], sel)
    np.testing.assert_array_equal(got["kept"], keep)
    np.testing.assert_allclose(got["y"], y, rtol=MOE_F32_RTOL,
                               atol=MOE_F32_ATOL * float(np.abs(y).max()))
    case = next(c for c in MOE_BLOCKS if c["name"] == name)
    groups = case["moe"].get("dispatch_groups", 1)
    gathered = [g for g in got["gathers"] if g[0] == "data"]
    # a group spanning the data split gathers the choices; groups that each
    # rank holds whole gather nothing
    assert bool(gathered) == (shape[0] > 1 and groups % shape[0] != 0), got["gathers"]


# -- training ---------------------------------------------------------------------


def _tid(c) -> str:
    shape, (arch, rules, dtype) = c
    return f"{shape[0]}x{shape[1]}-{arch.split('-')[0]}-{rules}-{dtype}"


def _got(results, shape, case) -> dict:
    return results[0][shape][2]["cases"][_key(case)]


def _train_bound(results, shape, case, part, name=None) -> float:
    """The bound at bfloat16, of max|x|: max(2e-2, d), d the reference's
    own sharded-vs-unsharded distance of `part` (the loss, or the largest
    over the leaves: a routing flip moves the gradient of every leaf
    before the router, not just the experts'). The routed experts' and the
    router's leaves get 2d', d' the larger of d and the reference's own
    bfloat16-vs-float32 distance there (ROADMAP.md §C's rule)."""
    ref = results[1]
    arch = case[0]
    s, u = ref[shape, case], ref[None, arch, case[2]]
    if name is None:
        return max(BF16_FLOOR, _rel(s[part], u[part]))
    leaves = [k for k in s[part] if k not in _zero(case)]
    d = max(_rel(s[part][k], u[part][k]) for k in leaves)
    if not (name.startswith("blocks/") and name.endswith(ROUTED)):
        return max(BF16_FLOOR, d)
    f32 = next(v for k, v in ref.items() if len(k) == 2 and isinstance(k[1], tuple)
               and k[1][0] == arch and str(k[1][1]).startswith("TRAIN") and k[1][2] == "float32")
    routed = [k for k in leaves if k.startswith("blocks/") and k.endswith(ROUTED)]
    return max(BF16_FLOOR, 2 * max([d] + [_rel(s[part][k], f32[part][k]) for k in routed]))


def _zero(case) -> set:
    """The top-1 router: a gradient zero but for rounding."""
    return {"blocks/mlp/router"} if case[0] == LLAMA4 else set()


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_loss_and_grads_match_reference(results, shape, case):
    got, want = _got(results, shape, case), results[1][shape, case]
    assert got["tokens"] == BATCH * SEQ
    assert sorted(got["grads"]) == sorted(want["grads"])
    f32 = case[2] == "float32"
    if f32:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    else:
        assert _rel(got["loss"], want["loss"]) <= _train_bound(results, shape, case, "loss")
    top = max(float(np.abs(w).max()) for w in want["grads"].values())
    for k, w in want["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape, k
        if k in _zero(case):
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= ZERO_GRAD * top, k
            continue
        if f32:
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL * float(np.abs(w).max()),
                                       err_msg=k)
        else:
            assert _rel(g, w) <= _train_bound(results, shape, case, "grads", k), (k, _rel(g, w))


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
    for k, spec in got["specs"].items():
        assert _split(spec, shape) == _split(want["specs"][k], shape), k
    for k, spec in got["grad_specs"].items():
        assert spec == got["specs"][f"params/{k}"], k
    if case[1] == "TRAIN_RULES":  # the experts over 'model', their embed dim over 'data'
        assert got["specs"]["params/blocks/mlp/w_gate"] == [None, "model", "data", None]
        assert got["specs"]["params/blocks/mlp/w_down"] == [None, "model", None, "data"]
    else:
        assert got["specs"]["params/blocks/mlp/w_gate"] == [None, "model", None, None]


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_backward_plans_no_collective_of_dtensors_own_but_all_reduce(results, shape, case):
    comm = _got(results, shape, case)["comm"]
    assert set(comm) <= ALLOWED_COLLECTIVES, comm
    assert comm["c10d_functional.all_reduce"] > 0
    fsdp = case[1] == "TRAIN_RULES" and shape == (2, 2)
    assert (comm.get("c10d._reduce_scatter_base_", 0) > 0) == (fsdp or case[0] == LLAMA4
                                                             and shape == (1, 4)), comm


@pytest.mark.parametrize("shape,case", TRAIN, ids=[_tid(c) for c in TRAIN])
def test_train_chained_compressed_steps_match_reference(results, shape, case):
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
            bound = _train_bound(results, shape, case, "loss")
            for k in ("loss", "grad_norm", "wire_bits_per_value"):
                assert _rel(g[k], w[k]) <= bound, (i, k, g[k], w[k])
    for part in ("params", "m", "v"):
        top = max(float(np.abs(w).max()) for w in want[part].values())
        for k, w in want[part].items():
            g = got[part][k]
            err, scale = np.abs(g - w), float(np.abs(w).max())
            if k in _zero(case):
                # Adam normalizes a gradient of rounding noise to steps of
                # about lr; its moments stay at the noise's size
                if part == "params":
                    assert float(err.max()) <= 2 * lr_sum, (part, k, float(err.max()))
                else:
                    assert max(float(np.abs(g).max()), scale) <= ZERO_GRAD * top, (part, k)
                continue
            if not f32:
                slack = 2 * lr_sum if part == "params" else 0.0
                bound = _train_bound(results, shape, case, part, k) * (2 if part == "v" else 1)
                assert float(err.max()) <= bound * scale + slack, (part, k, float(err.max()))
                continue
            off = int((err > F32_ATOL * scale).sum())
            assert off <= FLIP_SHARE * err.size, (part, k, off)
            most = 2 * lr_sum if part == "params" else FLIPPED_STATE * scale
            assert float(err.max()) <= F32_ATOL * scale + most, (part, k, float(err.max()))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_rank_reports_the_same_losses(results, shape):
    payloads = results[0][shape][0]
    for p in payloads[1:]:
        assert p["losses"] == payloads[0]["losses"] and p["launcher"] == payloads[0]["launcher"]
    assert payloads[0]["backend"] == "gloo"


def test_launcher_on_a_mesh_matches_unsharded(results):
    """`launch.train.run(mesh=)` of deepseek-v2 (compressed steps, an async
    save, the final save, a resume) on (2, 2) against the port's unsharded
    launcher on the same arguments: the losses within 2e-2 (bfloat16
    compute, the smoke config); the experts laid out by `TRAIN_RULES`."""
    first, again = results[4]
    got = results[0][(2, 2)][2]["launcher"]
    assert len(got["losses"]) == len(first) == 2 and len(got["resumed"]) == len(again) == 1
    for g, w in zip(got["losses"] + got["resumed"], first + again):
        assert abs(g - w) <= BF16_FLOOR * abs(w), (g, w)
    assert got["params_specs"]["blocks/mlp/w_up"] == [None, "model", "data", None]


# -- layouts and the sequence-split refusal -------------------------------------------


#: (arch, mesh, batch, max_len): the size-matching quirks of the reference's
#: `cache_sharding` on these caches
LAYOUT_CASES = {
    "deepseek-latent-b8-2x2": (DEEPSEEK, (2, 2), 8, PROMPT + GEN),
    "deepseek-latent-b8-1x4": (DEEPSEEK, (1, 4), 8, PROMPT + GEN),
    "deepseek-seq-as-long-as-heads-2x2": (DEEPSEEK, (2, 2), 8, 4),
    "deepseek-seq-as-long-as-heads-1x4": (DEEPSEEK, (1, 4), 8, 4),
    "llama4-stack-as-long-as-batch-2x2": (LLAMA4, (2, 2), 4, PROMPT + GEN),
    "llama4-stack-as-long-as-batch-1x4": (LLAMA4, (1, 4), 4, PROMPT + GEN),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_cache_layout_matches_reference(emulated_devices, name):
    arch, shape, batch, max_len = LAYOUT_CASES[name]
    rcfg = _r_cfg(arch)
    desc = r_build_model(rcfg).cache_desc(batch, max_len)
    heads = {rcfg.n_kv_heads, rcfg.n_heads}
    want = r_sh.cache_sharding(desc, _r_mesh(emulated_devices, shape), batch, heads)
    pcfg = reduced_for_smoke(get_config(arch))
    got = rsh.cache_sharding(build_model(pcfg, device="cpu").cache_desc(batch, max_len),
                             _stand_in(shape), batch, {pcfg.n_kv_heads, pcfg.n_heads})
    shapes = _named(desc)
    specs = {}
    for k, w in _named(want).items():
        node = got
        for part in k.split("/"):
            node = node[part]
        specs[k] = rsh.placements_to_spec(node.mesh, node.placements, len(shapes[k].shape))
        assert _pad(specs[k], len(shapes[k].shape)) == _pad(w.spec, len(shapes[k].shape)), k
    if arch == DEEPSEEK:
        seq = "model" if max_len == 4 else None
        assert specs["blocks/ckv"] == (None, "data", seq, None)
        assert specs["dense_blocks/krope"][2] == seq
    else:
        assert specs["blocks/k"][:2] == ("data", "model")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_into_a_sequence_split_cache_names_its_item(results, shape):
    """A write into a cache split along its sequence, and attention across
    its bands: deepseek's latent cache with `max_len` 4, a head count, whose
    sequence takes 'model' by size matching. The prefill's and the decode
    step's logits are the reference's (float32, `DECODE_F32`), its specs the
    reference's `cache_sharding`."""
    jobs, ref = results[:2]
    got = jobs[shape][1][LATENT["name"]]
    (steps, _), (_, cspec) = ref[shape, LATENT["name"]]
    assert got["cache_specs"]["blocks/ckv"] == cspec["blocks/ckv"] == [None, "data", "model", None]
    assert got["cache_specs"]["dense_blocks/krope"][2] == "model"
    assert len(got["logits"]) == len(steps) == LATENT["gen"]
    for i, (g, w) in enumerate(zip(got["logits"], steps)):
        assert _rel(g, w) <= DECODE_F32, (i, _rel(g, w))


@pytest.mark.parametrize("name", [c["name"] for c in MOE_BLOCKS])
def test_unsharded_moe_routing_is_the_references(name):
    """`blocks.moe_routing` on plain tensors: the reference's expert choices
    and kept flags on the capacity blocks' batch (float32, exact)."""
    from repro_torch.models import blocks as p_blocks
    from repro_torch.models import nn as p_nn

    case = next(c for c in MOE_BLOCKS if c["name"] == name)
    rcfg = _r_block_cfg(case)
    base = reduced_for_smoke(get_config(case["arch"]))
    pcfg = dataclasses.replace(base, dtype="float32",
                               moe=dataclasses.replace(base.moe, **case["moe"]))
    flat = _draw(r_blocks.desc_moe(rcfg), 2)
    x = np.random.default_rng(5).standard_normal(tuple(case["shape"]) + (rcfg.d_model,))
    x = x.astype(np.float32)
    sel, keep = _r_keep(W.nest({k: jnp.asarray(v) for k, v in flat.items()}), jnp.asarray(x), rcfg)
    params = p_nn.params_from_reference(W.nest(flat), device="cpu")
    got_sel, got_keep = p_blocks.moe_routing(params, torch.from_numpy(x), pcfg)
    assert int((~keep).sum()) > 0
    np.testing.assert_array_equal(got_sel.numpy(), sel)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    # the probe records the choices `apply_moe` routes by, and only while set
    p_blocks.ROUTING_LOG = []
    try:
        p_blocks.apply_moe(params, torch.from_numpy(x), pcfg)
        (logged,) = p_blocks.ROUTING_LOG
    finally:
        p_blocks.ROUTING_LOG = None
    np.testing.assert_array_equal(logged.numpy(), sel)
    p_blocks.apply_moe(params, torch.from_numpy(x), pcfg)
    assert p_blocks.ROUTING_LOG is None


def test_gather_dim_undoes_the_splits_innermost_first(monkeypatch):
    """`sharding.gather_dim` of a dim split over two mesh dims (a batch over
    ('pod', 'data')): it gathers over the later split first, over the
    extent of this rank's chunk of the earlier one (uneven: 7 rows over
    2 x 2 ranks), then over the earlier split's whole extent; a dim that
    no mesh dim splits is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(size=lambda j: 2, get_local_rank=lambda j: 1)
    calls = []

    def fake(local, mesh_, j, d, extent):
        calls.append((j, d, extent))
        return local

    monkeypatch.setattr(rsh, "_gather_local", fake)
    x = torch.zeros(1, 3)
    assert rsh.gather_dim(x, mesh, (Shard(0), Shard(0), Replicate()), 0, 7) is x
    # chunks of 7 over 2: (0, 4) and (4, 3); rank 1's chunk has 3 rows
    assert calls == [(1, 0, 3), (0, 0, 7)]
    calls.clear()
    assert rsh.gather_dim(x, mesh, (Replicate(), Shard(1), Replicate()), 0, 7) is x
    assert calls == []
