"""The port's xLSTM blocks (`repro_torch.models.xlstm`: the chunked mLSTM,
its decode step, the sLSTM) and the reduced xlstm-1.3b against the live
reference (`repro.models`) on the CPU, at `reduced_for_smoke` sizes
(chunk 16, 4 heads of 64 in the mLSTM, 2 groups of 1 mLSTM + 1 sLSTM),
with the reference's weights carried across by `nn.params_from_reference`
and inputs drawn from numpy seeds.

Tolerances (those of tests/test_torch_ssm.py, with their reasons):

* float32: rtol 1e-4 and atol 1e-5 * max|y|. Losses to rtol 1e-5.
* bfloat16, one block: atol 1.5e-2 * max|y|.
* bfloat16, the whole reduced model: atol max(1.5e-2, d) * max|logit|, d
  the distance between the reference's own bfloat16 and float32 logits.
* Decode through a cache: atol 1e-3 * max|logit|. The mLSTM's conv cache
  is bfloat16 whatever the compute dtype, in both packages.
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
from repro.models import xlstm as rx
from repro_torch.configs import get_config
from repro_torch.core import pytree
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.models import xlstm as px

XLSTM = "xlstm-1.3b"
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
    return (r_reduced(r_get_config(XLSTM)).scaled(**over),
            reduced_for_smoke(get_config(XLSTM)).scaled(**over))


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


def _state(seed, h=4, dk=16):
    """A nonzero mLSTM state (C, n, m) as numpy float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, h, dk, dk)).astype(np.float32),
            rng.standard_normal((B, h, dk)).astype(np.float32),
            rng.standard_normal((B, h)).astype(np.float32))


def _qkv_gates(seed, l, h=4, dk=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, l, h, dk)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((B, l, h)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.standard_normal((B, l, h)) + 2.0,
                                                 jnp.float32)))
    return q, k, v, ig, lf


# -- the mLSTM --------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("l", [16, 48])
def test_mlstm_chunked_matches_reference(l, with_state, dtype):
    """One chunk and three, from the -1e30 start and from a given state:
    the output in the inputs' dtype and the float32 state."""
    q, k, v, ig, lf = _qkv_gates(0, l)
    (rq, pq), (rk, pk), (rv, pv) = (_both(a, dtype) for a in (q, k, v))
    st = _state(1)
    rstate = tuple(jnp.asarray(a) for a in st) if with_state else None
    pstate = tuple(torch.from_numpy(a.copy()) for a in st) if with_state else None
    ry, rs = rx._mlstm_chunked(rq, rk, rv, jnp.asarray(ig), jnp.asarray(lf), 16, rstate)
    py, ps = px._mlstm_chunked(pq, pk, pv, torch.from_numpy(ig.copy()), torch.from_numpy(lf.copy()),
                               16, pstate)
    assert py.dtype == pq.dtype and tuple(py.shape) == q.shape
    _close_dtype(py, ry, dtype)
    for got, want in zip(ps, rs):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close_dtype(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_decode_step_matches_reference(dtype):
    q, k, v, ig, lf = _qkv_gates(2, 1)
    (rq, pq), (rk, pk), (rv, pv) = (_both(a[:, 0], dtype) for a in (q, k, v))
    st = _state(3)
    ry, rs = rx.mlstm_decode_step(rq, rk, rv, jnp.asarray(ig[:, 0]), jnp.asarray(lf[:, 0]),
                                  tuple(jnp.asarray(a) for a in st))
    py, ps = px.mlstm_decode_step(pq, pk, pv, torch.from_numpy(ig[:, 0]),
                                  torch.from_numpy(lf[:, 0]), tuple(torch.from_numpy(a) for a in st))
    assert py.dtype == pq.dtype
    _close_dtype(py, ry, dtype)
    for got, want in zip(ps, rs):
        _close_dtype(got, want, dtype)


def _block_pair(desc, cfgs, seed=1):
    rparams = rnn.init_tree(desc(cfgs[0]), jax.random.key(seed))
    return rparams, pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                              device="cpu")


def _cache(desc, seed, mlstm):
    """A nonzero cache for `desc` ({key: ShapeDtypeStruct}) as numpy; the
    mLSTM's conv (bfloat16 in both packages) rounded to bfloat16."""
    rng = np.random.default_rng(seed)
    out = {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32) for k, s in desc.items()}
    if mlstm:
        out["conv"] = np.asarray(jnp.asarray(out["conv"]).astype(jnp.bfloat16).astype(jnp.float32))
    return out


def _run_block(rapply, papply, rparams, pparams, cfgs, x, dtype, cache):
    rcfg, pcfg = cfgs
    rxx, pxx = _both(x, dtype)
    rcache = pcache = None
    if cache is not None:
        rcache = {k: jnp.asarray(v).astype(s.dtype) for k, v, s in
                  ((k, v, cache[1][k]) for k, v in cache[0].items())}
        pcache = {k: torch.from_numpy(v.copy()).to(torch.bfloat16 if k == "conv" and cache[2]
                                                    else torch.float32)
                  for k, v in cache[0].items()}
    ry, rnc = rapply(rparams, rxx, rcfg, cache=rcache)
    py, pnc = papply(pparams, pxx, pcfg, cache=pcache)
    assert py.dtype == pxx.dtype and tuple(py.shape) == x.shape
    _close_dtype(py, ry, dtype)
    if rcache is None:
        assert pnc is None
        return
    assert sorted(pnc) == sorted(rnc)
    for key in pnc:
        assert pnc[key] is pcache[key]  # written in place
        assert str(pnc[key].dtype).removeprefix("torch.") == str(rnc[key].dtype)
        _close_dtype(pnc[key], rnc[key], dtype)


#: (prompt length, mode), as tests/test_torch_ssm.py: padded, whole and
#: two-chunks-plus-padding prompts without and with a cache, and one token
#: with the cache (the decode step) and without it (the chunked path)
BLOCK_CASES = [(l, mode) for l in (12, 16, 37) for mode in ("no-cache", "cache")] + [
    (1, "decode"), (1, "one-token-no-cache")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,mode", BLOCK_CASES)
def test_apply_mlstm_matches_reference(l, mode, dtype):
    cfgs = _cfgs(dtype=dtype)
    rparams, pparams = _block_pair(rx.desc_mlstm, cfgs)
    x = np.random.default_rng(4).standard_normal((B, l, cfgs[1].d_model)).astype(np.float32)
    cache = None
    if mode in ("cache", "decode"):
        desc = rx.mlstm_cache_desc(cfgs[0], B)
        cache = (_cache(desc, 5, True), desc, True)
    _run_block(rx.apply_mlstm, px.apply_mlstm, rparams, pparams, cfgs, x, dtype, cache)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,mode", [(12, "no-cache"), (12, "cache"), (1, "decode")])
def test_apply_slstm_matches_reference(l, mode, dtype):
    """The time loop over 12 steps from zeros and from a nonzero cache, and
    one step with the cache."""
    cfgs = _cfgs(dtype=dtype)
    rparams, pparams = _block_pair(rx.desc_slstm, cfgs)
    x = np.random.default_rng(6).standard_normal((B, l, cfgs[1].d_model)).astype(np.float32)
    cache = None
    if mode != "no-cache":
        desc = rx.slstm_cache_desc(cfgs[0], B)
        cache = (_cache(desc, 7, False), desc, False)
    _run_block(rx.apply_slstm, px.apply_slstm, rparams, pparams, cfgs, x, dtype, cache)


def test_padding_uses_the_gates_that_leave_the_state_unchanged():
    """`apply_mlstm` pads a 12-token prompt to the chunk with input gate
    -1e30 and log forget gate 0: on such a padded chunk `_mlstm_chunked`
    ends in the state that 12 decode steps reach (C and n compared as
    C * e^m, n * e^m, since the two stabilizers differ), and the padded
    block leaves the reference's state."""
    q, k, v, ig, lf = _qkv_gates(9, 12)
    pad = [(0, 0), (0, 4), (0, 0), (0, 0)]
    qp, kp, vp = (torch.from_numpy(np.pad(a, pad)) for a in (q, k, v))
    igp = torch.from_numpy(np.pad(ig, pad[:3], constant_values=-1e30))
    lfp = torch.from_numpy(np.pad(lf, pad[:3]))
    _, (C, n, m) = px._mlstm_chunked(qp, kp, vp, igp, lfp, 16)
    state = (torch.zeros_like(C), torch.zeros_like(n), torch.full_like(m, px.M_INIT))
    for t in range(12):
        _, state = px.mlstm_decode_step(*(torch.from_numpy(a[:, t]) for a in (q, k, v, ig, lf)),
                                        state)
    e_chunk, e_step = torch.exp(m), torch.exp(state[2])
    _close(C * e_chunk[..., None, None], state[0] * e_step[..., None, None], 1e-5, 1e-4)
    _close(n * e_chunk[..., None], state[1] * e_step[..., None], 1e-5, 1e-4)

    cfgs = _cfgs(dtype="float32")
    rcfg, pcfg = cfgs
    rparams, pparams = _block_pair(rx.desc_mlstm, cfgs)
    x = np.random.default_rng(8).standard_normal((B, 12, pcfg.d_model)).astype(np.float32)
    desc = rx.mlstm_cache_desc(rcfg, B)
    rcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in desc.items()}
    rcache["m"] = jnp.full(desc["m"].shape, -1e30, jnp.float32)
    pcache = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rcache), device="cpu")
    _, rnc = rx.apply_mlstm(rparams, jnp.asarray(x), rcfg, cache=rcache)
    px.apply_mlstm(pparams, torch.from_numpy(x), pcfg, cache=pcache)
    for key in ("C", "n", "m"):
        _close(pcache[key], rnc[key], F32_ATOL, F32_RTOL)


def test_xlstm_descs_match_reference():
    rcfg, pcfg = _cfgs()
    for rdesc, pdesc in ((rx.desc_mlstm, px.desc_mlstm), (rx.desc_slstm, px.desc_slstm)):
        r, p = rdesc(rcfg), pdesc(pcfg)
        assert sorted(p) == sorted(r)
        for key in p:
            assert (p[key].shape, p[key].axes, p[key].init, p[key].scale) == (
                r[key].shape, r[key].axes, r[key].init, r[key].scale), key


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_cache_descs_match_reference(block):
    """Keys, shapes, dtypes: the mLSTM's conv is bfloat16 under a float32
    config, every other state float32."""
    rcfg, pcfg = _cfgs(dtype="float32")
    r = getattr(rx, f"{block}_cache_desc")(rcfg, 3)
    p = getattr(px, f"{block}_cache_desc")(pcfg, 3)
    assert sorted(p) == sorted(r)
    for key in p:
        assert p[key].shape == r[key].shape
        assert str(p[key].dtype).removeprefix("torch.") == str(r[key].dtype)
    if block == "mlstm":
        assert p["conv"].dtype == torch.bfloat16


# -- the reduced xlstm-1.3b -------------------------------------------------


def _pair(seed=0, **over):
    rcfg, pcfg = _cfgs(**over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    pmodel = build_model(pcfg, device="cpu")
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


def _tokens(cfg, seed, shape=(B, 40)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xlstm_logits_and_loss_match_reference(dtype):
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


def test_xlstm_init_cache_matches_reference():
    """`groups/{m,s}` stacked over groups and blocks; every mLSTM
    stabilizer starts at -1e30, the sLSTM's at zeros."""
    rmodel, _, pmodel, _ = _pair(dtype="float32")
    rc, pc = rmodel.init_cache(3, 8), pmodel.init_cache(3, 8)
    assert _tree_specs(pc) == _tree_specs(rc)
    assert pc["groups"]["m"]["C"].shape[:3] == (2, 1, 3)
    for block, keys in (("m", ("C", "n", "m", "conv")), ("s", ("c", "n", "m", "h"))):
        for key in keys:
            want = np.asarray(rc["groups"][block][key]).astype(np.float32)
            assert np.array_equal(pc["groups"][block][key].float().numpy(), want), (block, key)
    assert float(pc["groups"]["m"]["m"].max()) == float(np.float32(-1e30))


def test_xlstm_greedy_decode_matches_reference():
    """A 12-token prefill into the contiguous cache, then 8 greedy decode
    steps: equal token streams, logits within the cache tolerance, and the
    reference's cache tree (keys, shapes, dtypes; states within it)."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    toks = _tokens(pmodel.cfg, 1, (B, 12))
    rcache, pcache = rmodel.init_cache(B, 24), pmodel.init_cache(B, 24)
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
    for block, keys in (("m", ("C", "n", "m")), ("s", ("c", "n", "m", "h"))):
        for key in keys:
            _close(pcache["groups"][block][key], rcache["groups"][block][key], DECODE_ATOL)


def test_xlstm_second_prefill_from_a_nonzero_state():
    """Two cached prefills in a row, the second (21 tokens, across a chunk
    boundary) from the states the first left: the reference's logits."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    toks = _tokens(pmodel.cfg, 2, (B, 33))
    rcache, pcache = rmodel.init_cache(B, 40), pmodel.init_cache(B, 40)
    for s, e in ((0, 12), (12, 33)):
        rl, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(toks[:, s:e])}, rcache)
        pl, pcache = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks[:, s:e])}, pcache)
        _close(pl, rl, DECODE_ATOL)
    _close(pcache["groups"]["m"]["C"], rcache["groups"]["m"]["C"], DECODE_ATOL)


def test_xlstm_remat_gives_the_same_gradients():
    """Under autograd each group runs under `torch.utils.checkpoint`
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
