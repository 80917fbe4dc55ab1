"""The port's Mamba2 block (`repro_torch.models.ssm`) and the Zamba2-style
hybrid zamba2-1.2b against the live reference (`repro.models`) on the CPU,
at `reduced_for_smoke` sizes (chunk 16, state 16, heads of 16), with the
reference's weights carried across by `nn.params_from_reference` and
inputs drawn from numpy seeds.

Tolerances, each with its reason:

* float32: rtol 1e-4 and atol 1e-5 * max|y| (the same float32 math; sums
  in other orders). Losses to rtol 1e-5.
* bfloat16, one block: atol 1.5e-2 * max|y| (every activation rounds to
  bfloat16 after each op; the two packages' matmuls round their float32
  sums at different points).
* bfloat16, the whole reduced model: atol max(1.5e-2, d) * max|logit|,
  where d is the distance between the reference's own bfloat16 and
  float32 logits. Through the hybrid's stack of recurrences a bfloat16
  rounding flip grows: the reference's bfloat16 logits lie 3.8e-2 to
  9.0e-2 * max|logit| from its float32 ones (seeds 0-2), and its compiled
  and op-by-op runs differ by 4.6e-2 from each other, so no port can be
  held closer than bfloat16 moves the reference itself.
* Decode through a cache: atol 1e-3 * max|logit| (the shared attention
  stores K/V in bfloat16, see tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.core import pytree
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.models import ssm as pssm

ZAMBA2 = "zamba2-1.2b"
B = 2
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_ATOL = 1.5e-2
DECODE_ATOL = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are tiny, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return (r_reduced(r_get_config(ZAMBA2)).scaled(**over),
            reduced_for_smoke(get_config(ZAMBA2)).scaled(**over))


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, dtype=np.float32)


def _close(port, ref, atol_rel, rtol=0.0):
    ref = _np(ref)
    np.testing.assert_allclose(_np(port), ref, rtol=rtol, atol=atol_rel * float(np.abs(ref).max()))


def _close_dtype(port, ref, dtype):
    if dtype == "float32":
        _close(port, ref, F32_ATOL, F32_RTOL)
    else:
        _close(port, ref, BF16_ATOL)


def _both(a, dtype):
    """numpy `a` as (a jax array, a tensor) of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


# -- the block --------------------------------------------------------------


def _ssd_inputs(seed, l, h=8, p=16, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, l, h)), 0).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((B, l, n)).astype(np.float32)
    Cm = rng.standard_normal((B, l, n)).astype(np.float32)
    h0 = rng.standard_normal((B, h, n, p)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", [16, 48])
def test_ssd_chunked_matches_reference(l, with_h0, dtype):
    """One chunk and three, from zeros and from a given state: the output
    and the final state in the compute dtype."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(0, l)
    (rx, px), (rB, pB), (rC, pC), (rh, ph) = (_both(a, dtype) for a in (x, Bm, Cm, h0))
    ry, rhf = rssm.ssd_chunked(rx, jnp.asarray(dt), jnp.asarray(A), rB, rC, 16,
                               rh if with_h0 else None)
    py, phf = pssm.ssd_chunked(px, torch.from_numpy(dt), torch.from_numpy(A), pB, pC, 16,
                               ph if with_h0 else None)
    assert py.dtype == px.dtype and phf.dtype == px.dtype
    assert tuple(py.shape) == x.shape and tuple(phf.shape) == h0.shape
    _close_dtype(py, ry, dtype)
    _close_dtype(phf, rhf, dtype)


def test_segsum_masks_above_the_diagonal():
    log_a = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    ref = np.asarray(rssm._segsum(jnp.asarray(log_a)))
    got = pssm._segsum(torch.from_numpy(log_a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref)) and np.isneginf(got).sum() == 30
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-6, atol=1e-6)


def _mamba_pair(cfgs, seed=1):
    rcfg, _ = cfgs
    rparams = rnn.init_tree(rssm.desc_mamba(rcfg), jax.random.key(seed))
    # nonzero dt_bias and A_log, so the decay and softplus see real values
    rng = np.random.default_rng(seed)
    nh = rparams["A_log"].shape[0]
    rparams["dt_bias"] = jnp.asarray(rng.standard_normal(nh).astype(np.float32))
    rparams["A_log"] = jnp.asarray(0.5 * rng.standard_normal(nh).astype(np.float32))
    return rparams, pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                              device="cpu")


def _mamba_cache(cfg, seed):
    """A nonzero float32 cache, as numpy."""
    rng = np.random.default_rng(seed)
    desc = rssm.mamba_cache_desc(cfg, B)
    return {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32) for k, s in desc.items()}


#: (prompt length, mode): prompts of 12 (padded), 16 (one whole chunk) and
#: 37 (two chunks plus padding) tokens without and with a cache; one token
#: with the cache (the recurrent update) and without it (the chunked path)
BLOCK_CASES = [(l, mode) for l in (12, 16, 37) for mode in ("no-cache", "cache")] + [
    (1, "decode"), (1, "one-token-no-cache")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,mode", BLOCK_CASES)
def test_apply_mamba_matches_reference(l, mode, dtype):
    """`BLOCK_CASES` from a nonzero cache where there is one: the output,
    and the new cache with the reference's values, written in place."""
    cfgs = _cfgs(dtype=dtype)
    rcfg, pcfg = cfgs
    rparams, pparams = _mamba_pair(cfgs)
    x = np.random.default_rng(2).standard_normal((B, l, pcfg.d_model)).astype(np.float32)
    rx, px = _both(x, dtype)
    rcache = pcache = None
    if mode in ("cache", "decode"):
        c = _mamba_cache(rcfg, 3)
        rcache = {k: jnp.asarray(v) for k, v in c.items()}
        pcache = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    ry, rnc = rssm.apply_mamba(rparams, rx, rcfg, cache=rcache)
    py, pnc = pssm.apply_mamba(pparams, px, pcfg, cache=pcache)
    assert py.dtype == px.dtype and tuple(py.shape) == x.shape
    _close_dtype(py, ry, dtype)
    if rcache is None:
        assert pnc is None
        return
    assert sorted(pnc) == sorted(rnc) == ["conv", "h"]
    for key in pnc:
        assert pnc[key] is pcache[key]  # written in place
        assert pnc[key].dtype == torch.float32 and tuple(pnc[key].shape) == rnc[key].shape
        _close_dtype(pnc[key], rnc[key], dtype)


def test_padded_steps_leave_the_state_unchanged():
    """dt = 0 on the padding: the state after a 12-token prompt (padded to
    16) is the reference's, and equals the state after the same 12 tokens
    followed by nothing, within float32 rounding of the padded chunk."""
    cfgs = _cfgs(dtype="float32")
    rcfg, pcfg = cfgs
    rparams, pparams = _mamba_pair(cfgs)
    x = np.random.default_rng(4).standard_normal((B, 12, pcfg.d_model)).astype(np.float32)
    c = {k: np.zeros(s.shape, np.float32) for k, s in rssm.mamba_cache_desc(rcfg, B).items()}
    _, rnc = rssm.apply_mamba(rparams, jnp.asarray(x), rcfg, cache={k: jnp.asarray(v) for k, v in c.items()})
    pcache = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    pssm.apply_mamba(pparams, torch.from_numpy(x), pcfg, cache=pcache)
    _close(pcache["h"], rnc["h"], F32_ATOL, F32_RTOL)
    # token by token through the recurrent update reaches the same state
    step = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    for t in range(12):
        pssm.apply_mamba(pparams, torch.from_numpy(x[:, t:t + 1]), pcfg, cache=step)
    _close(step["h"], pcache["h"], 1e-4, 1e-4)


def test_softplus_has_no_threshold():
    """`jax.nn.softplus` is log(1 + e^x) for every x; torch's F.softplus
    returns x itself above 20."""
    x = np.asarray([-30.0, 0.0, 19.0, 20.5, 25.0], np.float32)
    np.testing.assert_array_equal(pssm._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_mamba_descs_match_reference():
    rcfg, pcfg = _cfgs()
    r, p = rssm.desc_mamba(rcfg), pssm.desc_mamba(pcfg)
    assert sorted(p) == sorted(r)
    for key in p:
        assert (p[key].shape, p[key].axes, p[key].init, p[key].scale) == (
            r[key].shape, r[key].axes, r[key].init, r[key].scale), key
    rc, pc = rssm.mamba_cache_desc(rcfg, 3), pssm.mamba_cache_desc(pcfg, 3)
    assert sorted(pc) == sorted(rc) == ["conv", "h"]
    for key in pc:
        assert pc[key].shape == rc[key].shape and pc[key].dtype == torch.float32
        assert rc[key].dtype == jnp.float32


# -- the reduced zamba2-1.2b ------------------------------------------------


def _pair(seed=0, **over):
    rcfg, pcfg = _cfgs(**over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    pmodel = build_model(pcfg, device="cpu")
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


def _tokens(cfg, seed, shape=(B, 40)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def test_layout_matches_reference():
    """2 groups of 2 Mamba layers plus a tail of 1 (reduced); 6 groups of 6
    plus 2 at full size."""
    for reduce, want in ((True, (2, 2, 1)), (False, (6, 6, 2))):
        pcfg, rcfg = get_config(ZAMBA2), r_get_config(ZAMBA2)
        if reduce:
            pcfg, rcfg = reduced_for_smoke(pcfg), r_reduced(rcfg)
        assert build_model(pcfg, device="cpu")._layout() == r_build_model(rcfg)._layout() == want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_zamba2_logits_and_loss_match_reference(dtype):
    rmodel, rparams, pmodel, pparams = _pair(dtype=dtype)
    toks = _tokens(pmodel.cfg, 0)
    labels = toks.copy()
    labels[:, -3:] = -1
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    rl, _ = rmodel.forward(rparams, rb)
    pl, _ = pmodel.forward(pparams, pb)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (B, 40, pmodel.cfg.vocab)
    rloss, _ = rmodel.loss(rparams, rb)
    ploss, pm = pmodel.loss(pparams, pb)
    assert float(pm["tokens"]) == B * 37
    if dtype == "float32":
        _close(pl, rl, F32_ATOL, F32_RTOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
        return
    # bfloat16: no closer than bfloat16 rounding moves the reference itself
    r32 = np.asarray(r_build_model(rmodel.cfg.scaled(dtype="float32")).forward(rparams, rb)[0])
    rl = np.asarray(rl)
    d = float(np.abs(rl - r32).max()) / float(np.abs(rl).max())
    _close(pl, rl, max(BF16_ATOL, d))
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-2)


def _tree_specs(tree, path=""):
    """{path: (shape, dtype name)} of a cache tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_tree_specs(tree[k], f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_zamba2_greedy_decode_matches_reference():
    """A 12-token prefill into the contiguous cache, then 8 greedy decode
    steps: equal token streams, logits within the cache tolerance, and
    cache trees with the reference's keys, shapes and dtypes (the Mamba
    states float32, the shared attention's one K/V stack per group)."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    toks = _tokens(pmodel.cfg, 1, (B, 12))
    rcache, pcache = rmodel.init_cache(B, 24), pmodel.init_cache(B, 24)
    assert _tree_specs(pcache) == _tree_specs(rcache)
    assert pcache["attn"]["k"].shape[0] == 2 and pcache["mamba_groups"]["h"].shape[:3] == (2, 2, B)
    rdecode = jax.jit(rmodel.decode_step)
    rl, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)}, rcache)
    pl, pcache = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcache)
    _close(pl[:, -1], np.asarray(rl)[:, -1], DECODE_ATOL)
    rtoks, ptoks = [], []
    for _ in range(8):
        rn = np.asarray(jnp.argmax(rl[:, -1], axis=-1)).astype(np.int32)[:, None]
        pn = torch.argmax(pl[:, -1], dim=-1).to(torch.int32)[:, None]
        rtoks.append(rn)
        ptoks.append(pn.numpy())
        rl, rcache = rdecode(rparams, jnp.asarray(rn), rcache)
        pl, pcache = pmodel.decode_step(pparams, pn, pcache)
        _close(pl, rl, DECODE_ATOL)
    assert np.array_equal(np.concatenate(ptoks, 1), np.concatenate(rtoks, 1))
    assert int(pcache["pos"]) == int(rcache["pos"]) == 20
    assert _tree_specs(pcache) == _tree_specs(rcache)
    for key in ("h", "conv"):
        _close(pcache["mamba_groups"][key], rcache["mamba_groups"][key], DECODE_ATOL)
        _close(pcache["mamba_tail"][key], rcache["mamba_tail"][key], DECODE_ATOL)


def test_zamba2_second_prefill_from_a_nonzero_state():
    """Two cached prefills in a row, the second (21 tokens, across a chunk
    boundary) starting from the states the first left: the reference's
    logits."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    toks = _tokens(pmodel.cfg, 2, (B, 33))
    rcache, pcache = rmodel.init_cache(B, 40), pmodel.init_cache(B, 40)
    for s, e in ((0, 12), (12, 33)):
        rl, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(toks[:, s:e])}, rcache)
        pl, pcache = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks[:, s:e])}, pcache)
        _close(pl, rl, DECODE_ATOL)
    assert float(pcache["mamba_tail"]["h"].abs().max()) > 0
    _close(pcache["mamba_tail"]["h"], rcache["mamba_tail"]["h"], DECODE_ATOL)


def test_zamba2_remat_gives_the_same_gradients():
    """Under autograd each Mamba layer runs under `torch.utils.checkpoint`
    (cfg.remat): the loss and every gradient equal those without it."""
    _, _, pmodel, pparams = _pair(dtype="float32")
    toks = torch.from_numpy(_tokens(pmodel.cfg, 3, (B, 20)))
    batch = {"tokens": toks, "labels": toks}
    leaves, treedef = pytree.flatten_with_path(pparams)

    def grads(model):
        tracked = [p.detach().requires_grad_(True) for _, p in leaves]
        loss, _ = model.loss(pytree.unflatten(treedef, tracked), batch)
        return loss, torch.autograd.grad(loss, tracked)

    l1, g1 = grads(pmodel)
    l0, g0 = grads(build_model(pmodel.cfg.scaled(remat=False), device="cpu"))
    assert torch.equal(l1, l0)
    for (path, _), a, b in zip(leaves, g1, g0):
        assert torch.equal(a, b), path
