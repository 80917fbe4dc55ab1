"""The port's MLA attention (`repro_torch.models.blocks.apply_mla`) and the
MLA + MoE decoder deepseek-v2-236b against the live reference
(`repro.models`) on the CPU, at `reduced_for_smoke` sizes, with the
reference's weights carried across by `nn.params_from_reference` and inputs
drawn from numpy seeds.

Tolerances (those of tests/test_torch_models.py, with their reasons):

* float32, no cache (the parallel path): rtol 1e-4 and atol
  1e-5 * max|y|. Losses to rtol 1e-5.
* bfloat16: atol 1.5e-2 * max|y| (every activation rounds to bfloat16
  after each op).
* Through a cache (the absorbed path, prefill and decode): atol
  1e-3 * max|y|. The cache holds the latent in bfloat16, so a float32
  value an ulp from a bfloat16 rounding midpoint in one package rounds to
  the other neighbour in the other.
"""

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

DEEPSEEK = "deepseek-v2-236b"
B, L = 2, 24
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_ATOL = 1.5e-2
CACHE_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are tiny, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return (r_reduced(r_get_config(DEEPSEEK)).scaled(**over),
            reduced_for_smoke(get_config(DEEPSEEK)).scaled(**over))


def _close(port, ref, atol_rel, rtol=0.0):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=rtol,
                               atol=atol_rel * float(np.abs(ref).max()))


def _mla_pair(dtype, seed=1, mla=None):
    rcfg, pcfg = _cfgs(dtype=dtype)
    if mla:
        rcfg = rcfg.scaled(mla=type(rcfg.mla)(**mla))
        pcfg = pcfg.scaled(mla=type(pcfg.mla)(**mla))
    rparams = rnn.init_tree(rblocks.desc_mla(rcfg), jax.random.key(seed))
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rcfg, pcfg, rparams, pparams


def _x(cfg, seed, length, dtype):
    x = np.random.default_rng(seed).standard_normal((B, length, cfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _positions(start, length):
    pos = np.broadcast_to(np.arange(start, start + length, dtype=np.int32), (B, length))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def test_desc_and_cache_desc_match_reference():
    rcfg, pcfg = _cfgs()
    r, p = rblocks.desc_mla(rcfg), pblocks.desc_mla(pcfg)
    assert sorted(p) == sorted(r)
    for key in p:
        assert (p[key].shape, p[key].axes, p[key].init) == (r[key].shape, r[key].axes, r[key].init)
    rc, pc = rblocks.mla_cache_desc(rcfg, 3, 20), pblocks.mla_cache_desc(pcfg, 3, 20)
    assert {k: tuple(v.shape) for k, v in pc.items()} == {k: tuple(v.shape) for k, v in rc.items()}
    assert pc["ckv"].dtype == torch.bfloat16 and pc["len"].dtype == torch.int32


#: the reduced config's MLA widths, and widths where q and k (qk_nope +
#: qk_rope = 48) are wider than v (32), as at full size (192 against 128)
MLA_WIDTHS = {"reduced": None, "qk-wider-than-v": dict(q_lora=64, kv_lora=32, qk_nope=32,
                                                       qk_rope=16, v_head=32)}


@pytest.mark.parametrize("widths", list(MLA_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parallel_path_matches_reference(dtype, widths):
    """No cache: K and V materialized, q and k qk_nope + qk_rope wide, v
    v_head wide, scaled by 1/sqrt(qk_nope + qk_rope)."""
    rcfg, pcfg, rparams, pparams = _mla_pair(dtype, mla=MLA_WIDTHS[widths])
    rx, px = _x(pcfg, 0, L, dtype)
    rpos, ppos = _positions(0, L)
    ry, _ = rblocks.apply_mla(rparams, rx, rpos, rcfg)
    py, pc = pblocks.apply_mla(pparams, px, ppos, pcfg)
    assert pc is None and py.dtype == px.dtype
    if dtype == "float32":
        _close(py, ry, F32_ATOL, F32_RTOL)
    else:
        _close(py, ry, BF16_ATOL)


def _zero_caches(rcfg, pcfg, max_len):
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in rblocks.mla_cache_desc(rcfg, B, max_len).items()}
    pc = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in pblocks.mla_cache_desc(pcfg, B, max_len).items()}
    return rc, pc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_prefill_and_decode_match_reference(dtype):
    """With a cache the absorbed form runs, for a prefill (L > 1) as for
    decode steps: each call's output and the cached latent against the
    reference's, and the absorbed prefill against the parallel path."""
    rcfg, pcfg, rparams, pparams = _mla_pair(dtype)
    max_len, pre = 20, 12
    rc, pc = _zero_caches(rcfg, pcfg, max_len)
    rx, px = _x(pcfg, 2, pre + 6, dtype)
    atol = CACHE_ATOL if dtype == "float32" else BF16_ATOL
    for s, e in [(0, pre)] + [(t, t + 1) for t in range(pre, pre + 6)]:
        rpos, ppos = _positions(s, e - s)
        rc["len"], pc["len"] = jnp.int32(s), torch.tensor(s, dtype=torch.int32)
        ry, rc = rblocks.apply_mla(rparams, rx[:, s:e], rpos, rcfg, cache=rc)
        py, pc = pblocks.apply_mla(pparams, px[:, s:e], ppos, pcfg, cache=pc)
        _close(py, ry, atol)
        assert int(pc["len"]) == int(rc["len"]) == e
        if s == 0:
            par, _ = pblocks.apply_mla(pparams, px[:, :pre], ppos, pcfg)
            scale = float(par.float().abs().max())
            assert float((py.float() - par.float()).abs().max()) <= (
                0.02 if dtype == "float32" else 0.06) * scale
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(pc[key].float().numpy(),
                                   np.asarray(rc[key].astype(jnp.float32)), rtol=2.0**-7, atol=1e-3)


def test_absorbed_write_clamps_like_dynamic_update_slice():
    """A write that would run past the cache's end starts at M - L instead
    (no ring buffer); the mask still takes the unclamped positions."""
    rcfg, pcfg, rparams, pparams = _mla_pair("float32")
    max_len = 8
    rc, pc = _zero_caches(rcfg, pcfg, max_len)
    rx, px = _x(pcfg, 3, 3, "float32")
    rpos, ppos = _positions(6, 3)
    rc["len"], pc["len"] = jnp.int32(6), torch.tensor(6, dtype=torch.int32)
    ry, rc = rblocks.apply_mla(rparams, rx, rpos, rcfg, cache=rc)
    py, pc = pblocks.apply_mla(pparams, px, ppos, pcfg, cache=pc)
    _close(py, ry, CACHE_ATOL)
    written = pc["ckv"].float().abs().sum(-1)[0]
    assert torch.equal(written > 0, torch.tensor([False] * 5 + [True] * 3))
    np.testing.assert_allclose(pc["ckv"].float().numpy(), np.asarray(rc["ckv"].astype(jnp.float32)),
                               rtol=2.0**-7, atol=1e-3)


# -- the reduced deepseek-v2-236b model -------------------------------------


def _pair(seed=0, **over):
    rcfg, pcfg = _cfgs(**over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    pmodel = build_model(pcfg, device="cpu")
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_logits_and_loss_match_reference(dtype):
    """One leading dense layer (`dense_blocks`) then MLA + MoE layers."""
    rmodel, rparams, pmodel, pparams = _pair(dtype=dtype)
    assert "dense_blocks" in pparams and "router" in pparams["blocks"]["mlp"]
    toks = _tokens(pmodel.cfg, 0, (B, 40))
    labels = toks.copy()
    labels[:, -3:] = -1
    rl, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    pl, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    rloss, _ = rmodel.loss(rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    ploss, _ = pmodel.loss(pparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})
    if dtype == "float32":
        _close(pl, rl, F32_ATOL, F32_RTOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    else:
        _close(pl, rl, BF16_ATOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-3)


def test_deepseek_greedy_decode_matches_reference():
    """A prefill into the contiguous cache, then 8 greedy decode steps in
    each package on its own tokens: the streams are equal, every step's
    logits agree within the cache tolerance, and both stacks' cached
    latents agree."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    prompt = _tokens(pmodel.cfg, 2, (B, 12))
    pcache, rcache = pmodel.init_cache(B, 24), rmodel.init_cache(B, 24)
    for stack in ("blocks", "dense_blocks"):
        assert {k: tuple(v.shape) for k, v in pcache[stack].items()} == {
            k: tuple(v.shape) for k, v in rcache[stack].items()}
    plg, pcache = pmodel.forward(pparams, {"tokens": torch.from_numpy(prompt)}, pcache)
    rlg, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(prompt)}, rcache)
    _close(plg, rlg, CACHE_ATOL)
    rdecode = jax.jit(rmodel.decode_step)
    ptok = rtok = np.asarray(plg[:, -1].argmax(-1).numpy(), np.int32)[:, None]
    assert np.array_equal(ptok[:, 0], np.asarray(rlg)[:, -1].argmax(-1))
    for _ in range(8):
        plg, pcache = pmodel.decode_step(pparams, torch.from_numpy(ptok), pcache)
        rlg, rcache = rdecode(rparams, jnp.asarray(rtok), rcache)
        _close(plg, rlg, CACHE_ATOL)
        ptok = plg[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        rtok = np.asarray(rlg)[:, -1].argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(ptok, rtok)
    assert int(pcache["pos"]) == int(rcache["pos"]) == 20
    for stack in ("blocks", "dense_blocks"):
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(
                pcache[stack][key].float().numpy(),
                np.asarray(rcache[stack][key].astype(jnp.float32)), rtol=2.0**-6, atol=2e-2)


def test_deepseek_has_no_paged_cache():
    """MLA keeps the contiguous cache, as in the reference: the paged
    descriptor raises and the batcher's auto-detect picks the legacy
    cache."""
    from repro_torch.runtime.batcher import ContinuousBatcher

    _, rparams, pmodel, pparams = _pair(dtype="float32")
    with pytest.raises(NotImplementedError, match="MLA"):
        pmodel.paged_cache_desc(2, 4, 8, 4)
    assert not ContinuousBatcher(pmodel, pparams, slots=2, max_len=16).paged
