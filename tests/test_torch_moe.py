"""The port's MoE block (`repro_torch.models.blocks.apply_moe`) and the MoE
decoder llama4-scout-17b-a16e against the live reference (`repro.models`)
on the CPU, at `reduced_for_smoke` sizes, with the reference's weights
carried across by `nn.params_from_reference` and inputs drawn from numpy
seeds.

Tolerances (those of tests/test_torch_models.py, with their reasons):

* float32: rtol 1e-4 and atol 1e-5 * max|y|, with exact routing: a token
  sent to another expert, or dropped where the reference keeps it, moves
  its output by O(max|y|), far outside this tolerance, so agreement here
  means every routing decision and capacity drop is the reference's.
  Losses to rtol 1e-5.
* bfloat16: atol 1.5e-2 * max|y| (every activation rounds to bfloat16
  after each op; the router's float32 softmax differs from XLA's by an
  ulp, which can move a renormalized top-k weight across a bfloat16
  rounding boundary).
* Decode through a cache: atol 1e-3 * max|logit| (the cache holds
  bfloat16 keys and values, see tests/test_torch_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import blocks as rblocks
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro_torch.configs import get_config
from repro_torch.models import blocks as pblocks
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn

LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
B, L = 2, 40
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_ATOL = 1.5e-2
DECODE_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are tiny, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, moe=None, **over):
    """The reduced config of `name` in both packages, with `over` and the
    MoE fields `moe` replaced."""
    rcfg, pcfg = r_reduced(r_get_config(name)), reduced_for_smoke(get_config(name))
    rover, pover = dict(over), dict(over)
    if moe:
        rover["moe"] = dataclasses.replace(rcfg.moe, **moe)
        pover["moe"] = dataclasses.replace(pcfg.moe, **moe)
    return rcfg.scaled(**rover), pcfg.scaled(**pover)


def _close(port, ref, atol_rel, rtol=0.0):
    ref = np.asarray(ref, dtype=np.float32)
    port = port.float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol_rel * float(np.abs(ref).max()))


def _moe_pair(rcfg, pcfg, seed, tie):
    rparams = rnn.init_tree(rblocks.desc_moe(rcfg), jax.random.key(seed))
    if tie:
        # experts 0 and 1 see equal router logits: top-k meets a tie wherever
        # they lead, and must take the lower index first
        rparams["router"] = rparams["router"].at[:, 1].set(rparams["router"][:, 0])
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rparams, pparams


MOE_CASES = {
    "llama4-top1-shared": dict(name=LLAMA4),
    "deepseek-top2-shared": dict(name=DEEPSEEK),
    "llama4-tie": dict(name=LLAMA4, tie=True),
    "deepseek-tie": dict(name=DEEPSEEK, tie=True),
    "llama4-drops": dict(name=LLAMA4, moe=dict(capacity_factor=0.1)),
    "deepseek-drops": dict(name=DEEPSEEK, moe=dict(capacity_factor=0.1)),
    "deepseek-groups-divide": dict(name=DEEPSEEK, moe=dict(dispatch_groups=4)),
    "deepseek-groups-fall-back": dict(name=DEEPSEEK, moe=dict(dispatch_groups=4), length=39),
    "llama4-groups-drops": dict(name=LLAMA4, moe=dict(dispatch_groups=4, capacity_factor=0.5)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case, dtype):
    c = MOE_CASES[case]
    rcfg, pcfg = _cfgs(c["name"], c.get("moe"), dtype=dtype)
    rparams, pparams = _moe_pair(rcfg, pcfg, 1, c.get("tie", False))
    length = c.get("length", L)
    x = np.random.default_rng(0).standard_normal((B, length, pcfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = rblocks.apply_moe(rparams, jnp.asarray(x).astype(jdt), rcfg).astype(jnp.float32)
    got = pblocks.apply_moe(pparams, torch.from_numpy(x).to(tdt), pcfg)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    if dtype == "float32":
        _close(got, ref, F32_ATOL, F32_RTOL)
    else:
        _close(got, ref, BF16_ATOL)


def _capacity(pcfg, n):
    mo = pcfg.moe
    g = mo.dispatch_groups if n % max(mo.dispatch_groups, 1) == 0 else 1
    ng = n // g
    return min(max(int(mo.capacity_factor * ng * mo.top_k / mo.n_experts), 8), ng)


def test_drops_and_groups_are_exercised():
    """The cases above reach what they name: capacity below the tokens an
    expert is offered, four groups where the count divides, one where it
    does not."""
    _, p = _cfgs(DEEPSEEK, dict(capacity_factor=0.1))
    assert _capacity(p, B * L) == 8 < B * L * p.moe.top_k / p.moe.n_experts
    _, p = _cfgs(DEEPSEEK, dict(dispatch_groups=4))
    assert (B * L) % 4 == 0 and (B * 39) % 4 != 0
    assert _capacity(p, B * L) == min(max(int(1.25 * 20 * 2 / 8), 8), 20)


def test_tie_takes_the_lower_expert():
    """Two experts with equal router columns: the stable sort puts the lower
    index first, as `jax.lax.top_k` does, so expert 1 never wins a tie
    (its output is zeroed to show it)."""
    rcfg, pcfg = _cfgs(LLAMA4, dtype="float32")
    rparams, pparams = _moe_pair(rcfg, pcfg, 1, tie=True)
    x = np.random.default_rng(0).standard_normal((B, L, pcfg.d_model)).astype(np.float32)
    xn = pnn.rms_norm(torch.from_numpy(x), pparams["norm"], pcfg.norm_eps)
    top = torch.argmax(pnn.dense(xn, pparams["router"]), dim=-1)
    assert int((top == 0).sum()) > 0  # the tied pair leads for some tokens
    zeroed = dict(pparams, w_down=pparams["w_down"].clone())
    zeroed["w_down"][1] = 0.0
    a = pblocks.apply_moe(pparams, torch.from_numpy(x), pcfg)
    b = pblocks.apply_moe(zeroed, torch.from_numpy(x), pcfg)
    assert torch.equal(a, b)
    ref = rblocks.apply_moe(rparams, jnp.asarray(x), rcfg)
    _close(a, ref, F32_ATOL, F32_RTOL)


def test_apply_moe_is_deterministic():
    rcfg, pcfg = _cfgs(DEEPSEEK, dtype="bfloat16")
    _, pparams = _moe_pair(rcfg, pcfg, 2, tie=False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((B, L, pcfg.d_model)))
    x = x.to(torch.bfloat16)
    assert torch.equal(pblocks.apply_moe(pparams, x, pcfg), pblocks.apply_moe(pparams, x, pcfg))


def test_desc_moe_matches_reference():
    rcfg, pcfg = _cfgs(LLAMA4)
    r, p = rblocks.desc_moe(rcfg), pblocks.desc_moe(pcfg)
    for key in ("norm", "router", "w_gate", "w_up", "w_down"):
        assert (p[key].shape, p[key].axes, p[key].init, p[key].scale) == (
            r[key].shape, r[key].axes, r[key].init, r[key].scale), key
    assert {k: v.shape for k, v in p["shared"].items()} == {k: v.shape for k, v in r["shared"].items()}


# -- the reduced llama4-scout-17b-a16e model --------------------------------


def _pair(seed=0, **over):
    rcfg, pcfg = _cfgs(LLAMA4, **over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    pmodel = build_model(pcfg, device="cpu")
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


def _tokens(cfg, seed, shape=(B, L)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama4_logits_and_loss_match_reference(dtype):
    rmodel, rparams, pmodel, pparams = _pair(dtype=dtype)
    toks = _tokens(pmodel.cfg, 0)
    labels = toks.copy()
    labels[:, -3:] = -1
    rl, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    pl, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (B, L, pmodel.cfg.vocab)
    rloss, _ = rmodel.loss(rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    ploss, _ = pmodel.loss(pparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})
    if dtype == "float32":
        _close(pl, rl, F32_ATOL, F32_RTOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    else:
        _close(pl, rl, BF16_ATOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-3)


def test_llama4_with_dense_layers_matches_reference():
    """`moe.n_dense_layers=1`: the leading dense layer sits in
    `dense_blocks` and runs before the MoE stack, in both packages."""
    rmodel, rparams, pmodel, pparams = _pair(moe=dict(n_dense_layers=1), dtype="float32")
    assert set(pparams) == set(rparams) and "dense_blocks" in pparams
    assert "router" not in pparams["dense_blocks"]["mlp"]
    toks = _tokens(pmodel.cfg, 1)
    rl, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    pl, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    _close(pl, rl, F32_ATOL, F32_RTOL)


def _greedy(step, prefill_logits, n):
    toks = [np.asarray(prefill_logits)[:, -1].argmax(-1).astype(np.int32)]
    for _ in range(n - 1):
        toks.append(step(toks[-1][:, None]))
    return np.stack(toks, 1)


@pytest.mark.parametrize("n_dense", [0, 1])
def test_llama4_greedy_decode_matches_reference(n_dense):
    """A prefill into the contiguous cache, then 8 greedy decode steps in
    each package on its own tokens: the streams are equal, and every step's
    logits agree within the decode tolerance."""
    rmodel, rparams, pmodel, pparams = _pair(moe=dict(n_dense_layers=n_dense), dtype="float32")
    prompt = _tokens(pmodel.cfg, 2, (B, 12))
    pcache, rcache = pmodel.init_cache(B, 24), rmodel.init_cache(B, 24)
    assert set(pcache) == set(rcache)
    for stack in set(pcache) - {"pos"}:
        assert {k: tuple(v.shape) for k, v in pcache[stack].items()} == {
            k: tuple(v.shape) for k, v in rcache[stack].items()}
    plg, pcache = pmodel.forward(pparams, {"tokens": torch.from_numpy(prompt)}, pcache)
    rlg, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(prompt)}, rcache)
    _close(plg, rlg, DECODE_ATOL)  # attention reads the bfloat16 cache
    rdecode = jax.jit(rmodel.decode_step)
    state = {"p": pcache, "r": rcache}

    def pstep(tok):
        lg, state["p"] = pmodel.decode_step(pparams, torch.from_numpy(tok), state["p"])
        return lg[:, -1].argmax(-1).numpy().astype(np.int32)

    def rstep(tok):
        lg, state["r"] = rdecode(rparams, jnp.asarray(tok), state["r"])
        return np.asarray(lg)[:, -1].argmax(-1).astype(np.int32)

    pstream = _greedy(pstep, plg.numpy(), 9)
    rstream = _greedy(rstep, np.asarray(rlg), 9)
    np.testing.assert_array_equal(pstream, rstream)
    assert int(state["p"]["pos"]) == int(state["r"]["pos"]) == 12 + 8


def test_llama4_paged_decode_matches_reference():
    """The paged branch through both stacks (`moe.n_dense_layers=1`): per-
    slot clocks and page tables over the shared arenas, a dead slot on
    scratch page 0."""
    rmodel, rparams, pmodel, pparams = _pair(moe=dict(n_dense_layers=1), dtype="float32")
    cfg = pmodel.cfg
    slots, pages, pt, max_pages = 3, 9, 4, 3
    ptab = np.asarray([[3, 1, 7], [2, 5, 0], [0, 0, 0]], np.int32)  # slot 2 dead
    lens = np.asarray([5, 2, 0], np.int32)
    rng = np.random.default_rng(6)
    pcache = pmodel.init_paged_cache(slots, pages, pt, max_pages)
    rcache = rmodel.init_paged_cache(slots, pages, pt, max_pages)
    for stack in ("blocks", "dense_blocks"):
        assert {k: tuple(v.shape) for k, v in pcache[stack].items()} == {
            k: tuple(v.shape) for k, v in rcache[stack].items()}
        for key in ("k", "v"):  # the same prior context in both arenas
            ctx = rng.standard_normal(tuple(pcache[stack][key].shape)).astype(np.float32)
            rcache[stack][key] = jnp.asarray(ctx).astype(jnp.bfloat16)
        pcache[stack] = pnn.params_from_reference(
            jax.tree_util.tree_map(np.asarray, rcache[stack]), device="cpu")
    rdecode = jax.jit(rmodel.decode_step)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab, (slots, 1)).astype(np.int32)
        pcache["pos"], pcache["page_table"] = torch.from_numpy(lens), torch.from_numpy(ptab)
        rcache["pos"], rcache["page_table"] = jnp.asarray(lens), jnp.asarray(ptab)
        lg, pcache = pmodel.decode_step(pparams, torch.from_numpy(tok), pcache)
        rlg, rcache = rdecode(rparams, jnp.asarray(tok), rcache)
        _close(lg[:2], np.asarray(rlg)[:2], DECODE_ATOL)  # live slots
        lens = lens + np.asarray([1, 1, 0], np.int32)
    live = np.asarray(sorted({int(p) for p in ptab[:2].ravel()} - {0}))
    for stack in ("blocks", "dense_blocks"):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                pcache[stack][key][:, live].float().numpy(),
                np.asarray(rcache[stack][key][:, live]).astype(np.float32), rtol=0, atol=2e-2)
