"""Serving under a mesh on the port (`repro_torch.runtime.sharding.activate`,
`cache_sharding`, the dense decoder on DTensors) against the reference's
`repro.runtime.sharding`.

`cache_sharding` and the activation guard are held to the reference's
directly. The serving path runs as two 4-rank gloo jobs
(`repro_torch.launch.mhrun`, `tests/torch_shard_worker.py`), one on a
(2, 2) and one on a (1, 4) ('data', 'model') mesh: the reduced phi4-mini
at float32 and bfloat16, batch 4 (as long as the layer stack: the
reference's `cache_sharding` then splits the stack over 'data') and batch
8, laid out by `SERVE_RULES`, through `launch.serve.run_static(mesh=)`.
The reference runs the same weights under its `activate` on an
`AxisType.Auto` mesh of four emulated devices (its `jax.make_mesh` meshes
are Explicit, where its constraint fails: ROADMAP.md §C), params placed
by its `tree_shardings`.

The same jobs serve the dry run's cache variants (`launch/dryrun.py`),
batch 8 at both dtypes: the int8 KV cache on the reduced phi4-mini
(`kvq8`), and a cache split along its sequence
(`cache_sharding(seq_shard=True)`) on a reduced smollm-360m (2 layers)
whose 3 KV heads divide no 'model' here, alone (`seqkv`) and with the int8 cache
(`combo`), 512 rows (128 x 4) from a 507-token prefill; the reference's
cache is placed by the same `cache_sharding` first. The int8 cache is
compared as values (codes x scale), a code one step off allowed: the
int8 analog of the bfloat16 cache's rounding flip.

Tolerances, each with its reason:

* float32, the forward without a cache: 1e-5 * max|logit| (the same
  float32 math; the split products add their partials in another order).
* float32, prefill and teacher-forced decode through the cache: 1e-3 *
  max|logit|, `tests/test_torch_models.py`'s `DECODE_ATOL`: the cache
  holds K/V in bfloat16, and a key a float32 ulp from a rounding midpoint
  in one run rounds to the other neighbour in the other.
* bfloat16: max(2e-2, d) * max|logit|, d the reference's own distance
  between its sharded and unsharded runs.
* the gathered cache against the port's unsharded cache: at float32 one
  bfloat16 ulp (2^-7 of the value: a key rounded to the other neighbour)
  plus the steps' 1e-3 of max|cache| (what that moves in the next
  layers); at bfloat16 the bound above, of max|cache|.
"""

import argparse
import dataclasses
import os
import pickle
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import nn as r_nn
from repro.models import reduced_for_smoke as r_reduced
from repro.runtime import sharding as r_sh
from repro.runtime import steps as r_steps
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn
from repro_torch.runtime import sharding as rsh

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

ARCH = "phi4-mini-3.8b"
PROMPT, GEN = 16, 5  # the prefill and 4 teacher-forced decode steps
MESHES = [(2, 2), (1, 4)]
BASE_CASES = [("float32", 4), ("float32", 8), ("bfloat16", 4), ("bfloat16", 8)]
#: the dry run's cache variants: the int8 cache on the reduced phi4-mini;
#: a cache split along its sequence on a reduced smollm-360m (2 layers)
#: whose 3 KV heads divide neither mesh's 'model' (its 6 query heads split
#: on (2, 2) and not on (1, 4)), alone and with the int8 cache, its 512
#: rows (128 x 4) filled by a 507-token prefill and 4 decode steps
SEQ_ARCH, SEQ_PROMPT = "smollm-360m", 507
SEQ_OVERRIDES = dict(n_heads=6, n_kv_heads=3, n_layers=2)
VARIANTS = {
    f"{variant}/{dtype}/8": dict(
        name=f"{variant}/{dtype}/8", variant=variant, dtype=dtype, batch=8, gen=GEN,
        arch=ARCH if variant == "kvq8" else SEQ_ARCH,
        overrides={} if variant == "kvq8" else SEQ_OVERRIDES,
        prompt_len=PROMPT if variant == "kvq8" else SEQ_PROMPT,
        weights="weights.npz" if variant == "kvq8" else "weights-seq.npz")
    for variant in ("kvq8", "seqkv", "combo") for dtype in ("float32", "bfloat16")
}
CASES = BASE_CASES + [(v["dtype"], v["batch"], name) for name, v in VARIANTS.items()]
FORWARD_F32, DECODE_F32, BF16_FLOOR = 1e-5, 1e-3, 2e-2
BF16_ULP = 2.0 ** -7


def _stand_in(shape, names=("data", "model")):
    """What `cache_sharding` and the guard read of a mesh: its dim names and
    shape (no process group in this process)."""
    return types.SimpleNamespace(mesh_dim_names=names, mesh=torch.arange(int(np.prod(shape))).reshape(shape))


def _r_mesh(emulated_devices, shape):
    return Mesh(np.array(emulated_devices[: int(np.prod(shape))]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * len(shape))


def _pad(spec, ndim) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _port_spec(sharding, ndim) -> tuple:
    return rsh.placements_to_spec(sharding.mesh, sharding.placements, ndim)


# -- cache_sharding ----------------------------------------------------------


def _reduced_cache(batch):
    cfg = r_reduced(r_get_config(ARCH))
    return r_build_model(cfg).cache_desc(batch, PROMPT + GEN), {cfg.n_kv_heads, cfg.n_heads}


#: (mesh shape, leaves {name: shape}, batch, head sizes, seq_shard): the
#: contracts of tests/test_sharding.py and the reduced phi4-mini's caches
CACHE_CASES = {
    "finds_batch_and_heads": ((1, 1), {"k": (32, 128, 1024, 8, 64), "pos": ()}, 128, {8}, False),
    "no_head_match": ((1, 1), {"k": (32, 128, 4096, 3, 64)}, 128, {999}, False),
    "seq_fallback": ((1, 1), {"k": (32, 128, 4096, 3, 64)}, 128, {999}, True),
    "head_before_seq": ((1, 1), {"k": (32, 128, 4096, 3, 64)}, 128, {3}, True),
    "multidevice_2x4": ((2, 4), {"k": (4, 16, 256, 8, 16)}, 16, {8}, False),
    "phi4_reduced_b8_2x2": ((2, 2), "reduced", 8, None, False),
    "phi4_reduced_b8_1x4": ((1, 4), "reduced", 8, None, False),
    "phi4_reduced_b4_stack_quirk_2x2": ((2, 2), "reduced", 4, None, False),
    "phi4_reduced_b4_stack_quirk_1x4": ((1, 4), "reduced", 4, None, False),
}


@pytest.mark.parametrize("name", sorted(CACHE_CASES))
def test_cache_sharding_matches_reference(emulated_devices, name):
    shape, leaves, batch, heads, seq = CACHE_CASES[name]
    if leaves == "reduced":
        desc, heads = _reduced_cache(batch)
    else:
        desc = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in leaves.items()}
    want = r_sh.cache_sharding(desc, _r_mesh(emulated_devices, shape), batch, heads, seq_shard=seq)
    mesh = _stand_in(shape)
    got = rsh.cache_sharding(desc, mesh, batch, heads, seq_shard=seq)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat_w:
        node, leaf = got, desc
        for k in path:
            node, leaf = node[k.key], leaf[k.key]
        assert node.mesh is mesh
        assert _port_spec(node, len(leaf.shape)) == _pad(w.spec, len(leaf.shape)), (path, w.spec)
    if name.startswith("phi4_reduced_b4_stack_quirk"):
        # the stack is as long as the batch: it takes the data split, the
        # batch the model split
        assert _port_spec(got["blocks"]["k"], 5) == ("data", "model", None, None, None)


# -- the activation guard ----------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("shape,axes", [
    ((4, 6, 8), ("batch", None, "heads")),
    ((3, 6, 6), ("batch", None, "heads")),
    ((8, 4, 2, 32), ("batch", None, "heads", None)),
    ((8, 512), ("batch", "vocab")),
])
def test_guard_drops_mesh_dims_that_do_not_divide(emulated_devices, monkeypatch, mesh_shape,
                                                  shape, axes):
    """The constraint's spec (what survives the divisibility guard) is the
    one the reference's constraint asks for on the same array."""
    asked = []
    monkeypatch.setattr(r_sh.jax.lax, "with_sharding_constraint",
                        lambda x, sharding: asked.append(sharding) or x)
    with r_sh.activate(_r_mesh(emulated_devices, mesh_shape), r_sh.SERVE_RULES):
        r_nn.shard(np.zeros(shape, np.float32), *axes)
    want = _pad(asked[0].spec, len(shape))
    got = rsh.ActivationLayout(_stand_in(mesh_shape), rsh.SERVE_RULES).spec(shape, axes)
    assert got == want


def test_activate_binds_and_unbinds_the_hook():
    mesh = _stand_in((2, 2))
    x = torch.zeros(4, 8)
    assert nn.shard_fn() is None
    with rsh.activate(mesh, rsh.SERVE_RULES):
        assert isinstance(nn.shard_fn(), rsh.ActivationLayout)
        assert nn.shard_fn().mesh is mesh
        assert nn.shard(x, "batch") is x  # the axes do not name every dim
    assert nn.shard_fn() is None
    with pytest.raises(KeyError):
        with rsh.activate(mesh, rsh.SERVE_RULES):
            raise KeyError("body")
    assert nn.shard_fn() is None
    assert nn.shard(x, "batch", None) is x


# -- the 4-rank serving jobs ---------------------------------------------------


def _draw(cfg) -> dict:
    params = nn.init_tree(build_model(cfg, device="cpu").desc(), torch.Generator().manual_seed(0),
                          device="cpu")
    return {k: v.numpy() for k, v in W._flat(params).items()}


@pytest.fixture(scope="module")
def weights():
    cfg = reduced_for_smoke(get_config(ARCH))
    teacher = np.random.default_rng(3).integers(1, cfg.vocab, (8, GEN - 1)).astype(np.int32)
    return {"weights.npz": _draw(cfg),
            "weights-seq.npz": _draw(W.variant_config(SEQ_ARCH, "float32", "seqkv",
                                                      SEQ_OVERRIDES))}, teacher


def _key(case) -> str:
    return case[2] if len(case) == 3 else f"{case[0]}/{case[1]}"


def _variant(case) -> dict | None:
    return VARIANTS[case[2]] if len(case) == 3 else None


def _port_cfg(case):
    v = _variant(case)
    if v is None:
        return dataclasses.replace(reduced_for_smoke(get_config(ARCH)), dtype=case[0])
    return W.variant_config(v["arch"], v["dtype"], v["variant"], v["overrides"])


def _r_cfg(case):
    v = _variant(case)
    if v is None:
        return dataclasses.replace(r_reduced(r_get_config(ARCH)), dtype=case[0])
    cfg = dataclasses.replace(r_reduced(r_get_config(v["arch"])), dtype=v["dtype"],
                              **v["overrides"])
    return dataclasses.replace(cfg, kv_quant=v["variant"] in ("kvq8", "combo"))


def _lengths(case) -> tuple[int, int]:
    v = _variant(case)
    return (PROMPT, GEN) if v is None else (v["prompt_len"], v["gen"])


def _seq_shard(case) -> bool:
    v = _variant(case)
    return v is not None and v["variant"] in ("seqkv", "combo")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, weights):
    """Both meshes' jobs, run at once: {mesh: (payloads, {case: record})}."""
    flat, teacher = weights
    out, errors = {}, []

    def run(shape):
        wd = tmp_path_factory.mktemp(f"mesh_{shape[0]}x{shape[1]}")
        for name, f in flat.items():
            np.savez(wd / name, **f)
        np.save(wd / "teacher.npy", teacher)
        try:
            payloads = W.run_job("mesh_serve", 4, wd, timeout_s=300, args=dict(
                mesh=list(shape), cases=BASE_CASES + list(VARIANTS.values()), arch=ARCH,
                prompt_len=PROMPT, gen=GEN))
        except AssertionError as e:  # reported below, in the test's thread
            errors.append(e)
            return
        with open(wd / "mesh_serve.pkl", "rb") as f:
            out[shape] = (payloads, pickle.load(f))

    threads = [threading.Thread(target=run, args=(s,)) for s in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(360)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


def _r_params(flat, mesh=None, model=None):
    tree = W.nest({k: np.asarray(v) for k, v in flat.items()})
    if mesh is None:
        return jax.tree_util.tree_map(jax.numpy.asarray, tree)
    desc = model.desc()
    shard = r_sh.tree_shardings(r_nn.axes_tree(desc), r_sh.SERVE_RULES, mesh, r_nn.abstract_tree(desc))
    return jax.tree_util.tree_map(jax.device_put, tree, shard)


def _r_serve(cfg, params, model, batch, teacher, mesh, case):
    """The reference's prefill and teacher-forced decode steps (and, but for
    a cache variant, its forward without a cache), under its `activate`
    when `mesh` is given: last-position logits per step, the forward's
    logits. A sequence-split variant's cache is placed by
    `cache_sharding(seq_shard=True)` first."""
    prompt, gen = _lengths(case)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (batch, prompt)).astype(np.int32)
    prefill = jax.jit(r_steps.make_prefill_step(model))
    decode = jax.jit(lambda p, t, c: model.forward(p, {"tokens": t}, cache=c))
    forward = jax.jit(lambda p, t: model.forward(p, {"tokens": t})[0])

    def body():
        cache = model.init_cache(batch, prompt + gen)
        if mesh is not None and _seq_shard(case):
            cache = jax.device_put(cache, r_sh.cache_sharding(
                model.cache_desc(batch, prompt + gen), mesh, batch,
                {cfg.n_kv_heads, cfg.n_heads}, seq_shard=True))
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        out = [np.asarray(logits[:, -1], np.float32)]
        for i in range(gen - 1):
            lg, cache = decode(params, teacher[:batch, i:i + 1], cache)
            out.append(np.asarray(lg[:, -1], np.float32))
        if _variant(case) is not None:
            return out, None
        return out, np.asarray(forward(params, prompts), np.float32)

    if mesh is None:
        return body()
    with r_sh.activate(mesh, r_sh.SERVE_RULES):
        return body()


@pytest.fixture(scope="module")
def ref(emulated_devices, weights):
    """{(mesh or None, case): (step logits, forward logits)} and the param
    and cache specs of each mesh and batch."""
    files, teacher = weights
    runs, specs = {}, {}
    for case in CASES:
        dtype, batch = case[:2]
        flat = files[_variant(case)["weights"] if _variant(case) else "weights.npz"]
        cfg = _r_cfg(case)
        model = r_build_model(cfg)
        if dtype == "bfloat16":
            runs[None, case] = _r_serve(cfg, _r_params(flat), model, batch, teacher, None, case)
        for shape in MESHES:
            mesh = _r_mesh(emulated_devices, shape)
            runs[shape, case] = _r_serve(
                cfg, _r_params(flat, mesh, model), model, batch, teacher, mesh, case)
            desc = model.desc()
            pspec = r_sh.tree_shardings(r_nn.axes_tree(desc), r_sh.SERVE_RULES, mesh,
                                        r_nn.abstract_tree(desc))
            cdesc = model.cache_desc(batch, sum(_lengths(case)))
            cspec = r_sh.cache_sharding(cdesc, mesh, batch, {cfg.n_kv_heads, cfg.n_heads},
                                        seq_shard=_seq_shard(case))
            specs[shape, _key(case)] = (
                {k: list(_pad(v.spec, len(W._flat(r_nn.abstract_tree(desc))[k].shape)))
                 for k, v in W._flat(pspec).items()},
                {k: list(_pad(v.spec, len(W._flat(cdesc)[k].shape)))
                 for k, v in W._flat(cspec).items()},
            )
    return runs, specs


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _bf16_bound(ref, case) -> float:
    """max(2e-2, d): d the reference's own sharded-vs-unsharded distance
    over the steps of this bfloat16 case, on either mesh."""
    runs, _ = ref
    d = max(_rel(s, u) for shape in MESHES
            for s, u in zip(runs[shape, case][0], runs[None, case][0]))
    return max(BF16_FLOOR, d)


def _cid(case) -> str:
    return _key(case).replace("/", "-") if len(case) == 3 else f"{case[0]}-b{case[1]}"


def _lists(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("shape", MESHES)
def test_guard_contract_on_the_ranks(jobs, shape):
    """On every rank: a plain tensor is placed by its box, a DTensor
    redistributed, a mismatched axes tuple returns the tensor, the hook is
    bound inside `activate` and unbound after."""
    payloads, _ = jobs[shape]
    layout = rsh.ActivationLayout(_stand_in(shape), rsh.SERVE_RULES)
    for p in payloads:
        g = p["guard"]
        assert g["placed"] == _lists(layout.spec((4, 6, 8), ("batch", None, "heads")))
        assert g["odd"] == _lists(layout.spec((3, 6, 6), ("batch", None, "heads")))
        assert g["back"] == [None, None, None]
        assert g["same"] and g["bound"] and g["unbound"] and g["box"] and g["back_equal"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_logits_match_reference(jobs, ref, shape, case):
    runs, _ = ref
    got = jobs[shape][1][_key(case)]
    steps, forward = runs[shape, case]
    assert len(got["logits"]) == len(steps) == _lengths(case)[1]
    bound = DECODE_F32 if case[0] == "float32" else _bf16_bound(ref, case)
    if forward is not None:
        assert _rel(got["forward"], forward) <= (FORWARD_F32 if case[0] == "float32" else bound)
    for i, (g, w) in enumerate(zip(got["logits"], steps)):
        assert _rel(g, w) <= bound, (i, _rel(g, w), bound)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_placements_match_reference(jobs, ref, shape, case):
    _, specs = ref
    got = jobs[shape][1][_key(case)]
    pspec, cspec = specs[shape, _key(case)]
    assert got["param_specs"] == {k: _lists(v) for k, v in pspec.items()}
    assert got["cache_specs"] == {k: _lists(v) for k, v in cspec.items()}
    if _seq_shard(case):  # the sequence takes 'model': the cache is not replicated over it
        for k in ("blocks/k", "blocks/v") + (("blocks/k_scale", "blocks/v_scale")
                                             if "combo" in case[2] else ()):
            assert got["cache_specs"][k][2] == "model", k
    elif shape == (1, 4):  # the reduced model's 2 KV heads do not divide 4 ranks
        assert got["cache_specs"]["blocks/k"][3] is None


def _values(cache: dict) -> dict:
    """The int8 cache's codes as values (codes x scale), and each code
    step (the scale) beside them; other leaves as they are, no step."""
    out = {}
    for k, v in cache.items():
        if k.endswith("_scale"):
            out[k] = (v, None)
        elif f"{k}_scale" in cache:
            scale = cache[f"{k}_scale"][..., None]
            out[k] = (v * scale, np.broadcast_to(scale, v.shape))
        else:
            out[k] = (v, None)
    return out


_UNSHARDED: dict = {}


def _unsharded(weights, case) -> dict:
    """The port's unsharded `run_static` of a case (run once)."""
    if case not in _UNSHARDED:
        files, teacher = weights
        cfg = _port_cfg(case)
        flat = files[_variant(case)["weights"] if _variant(case) else "weights.npz"]
        params = W.nest({k: torch.from_numpy(v) for k, v in flat.items()})
        prompt, gen = _lengths(case)
        args = argparse.Namespace(batch=case[1], prompt_len=prompt, gen=gen, sample=False)
        _UNSHARDED[case] = serve.run_static(args, cfg, build_model(cfg, device="cpu"), params,
                                            teacher=teacher[:case[1]], keep=True)
    return _UNSHARDED[case]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_gathered_cache_matches_unsharded(jobs, ref, weights, shape, case):
    """The gathered cache against the port's unsharded run at the file's
    bounds; the int8 cache as values, a code one step off allowed (its
    analog of the bfloat16 cache's rounding flip)."""
    dtype = case[0]
    res = _unsharded(weights, case)
    got = _values(jobs[shape][1][_key(case)]["cache"])
    bound = DECODE_F32 if dtype == "float32" else _bf16_bound(ref, case)
    for k, (want, step) in _values({k: v.to(torch.float32).numpy()
                                    for k, v in W._flat(res["cache"]).items()}).items():
        if k == "pos":
            assert np.array_equal(got[k][0], want)
        elif dtype == "float32":
            err = np.abs(got[k][0] - want)
            tol = BF16_ULP * np.abs(want) + DECODE_F32 * float(np.abs(want).max())
            if step is not None:
                tol = tol + np.maximum(step, got[k][1])
            assert np.all(err <= tol), (k, float((err - tol).max()))
        else:
            assert _rel(got[k][0], want) <= bound, k
    # the unsharded run's logits are the sharded run's, within the bounds above
    for g, w in zip(jobs[shape][1][_key(case)]["logits"], res["logits"]):
        assert _rel(g, w.numpy()) <= bound


@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_the_same_tokens(jobs, shape):
    payloads, _ = jobs[shape]
    for p in payloads[1:]:
        assert p["tokens"] == payloads[0]["tokens"]
    assert payloads[0]["backend"] == "gloo"



@pytest.mark.parametrize("start,length", [(0, 4), (5, 4), (6, 1), (9, 3), (12, 2), (2, 12)])
def test_band_write_writes_only_the_rows_in_the_band(start, length):
    """`nn._write_band` on one rank's band, rows 4..11 of a sequence split
    in bands of 8 (rows written across its start, inside it, across its
    end, past it, over it whole): the rows in the band take their new
    values, every other row keeps its own, whatever the duplicate indices
    the band's `index_copy_` is given."""
    gen = torch.Generator().manual_seed(4)
    band = torch.randn(2, 8, 3, generator=gen)
    new = torch.randn(2, length, 3, generator=gen)
    want = band.clone()
    for i in range(length):
        if 4 <= start + i < 12:
            want[:, start + i - 4] = new[:, i]
    got = band.clone()
    nn._write_band(got, torch.arange(start, start + length) - 4, new)
    assert torch.equal(got, want)
