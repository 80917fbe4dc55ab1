"""The port's encoder-decoder (`EncDecLM`, cross-attention in
`blocks.apply_attn(memory=)`) and `launch.serve.run_static` against the live
reference (`repro.models`, `repro.runtime.steps`) on the CPU, for the
reduced seamless-m4t-large-v2 (2 encoder and 4 decoder layers, d_model
128, 16 frames), with the reference's weights carried across by
`nn.params_from_reference` and inputs drawn from numpy seeds.

Tolerances, each with its reason:

* float32: rtol 1e-4 and atol 1e-5 * max|y| (the same float32 math; sums
  in other orders, XLA's `rsqrt`, `cos`, `sin` a few ulps from torch's).
  Losses to rtol 1e-5.
* bfloat16: atol 1.5e-2 * max|y| (every activation rounds to bfloat16
  after each op; the two packages' matmuls round their float32 sums at
  different points).
* Decode through a cache: atol 1e-3 * max|logit| (the self-attention K/V
  are stored in bfloat16, see tests/test_torch_models.py).
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
from repro.runtime import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.core import pytree
from repro_torch.launch import serve
from repro_torch.models import blocks as pblocks
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn

SEAMLESS = "seamless-m4t-large-v2"
B, L = 2, 12
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
    return (r_reduced(r_get_config(SEAMLESS)).scaled(**over),
            reduced_for_smoke(get_config(SEAMLESS)).scaled(**over))


def _from_ref(tree):
    return pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _pair(seed=0, **over):
    rcfg, pcfg = _cfgs(**over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    return rmodel, rparams, build_model(pcfg, device="cpu"), _from_ref(rparams)


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


def _batch(cfg, seed, l=L, frames_len=None):
    """(reference batch, port batch): tokens, labels with the last 3
    masked, and frames of `frames_len` (default the config's) steps."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, l)).astype(np.int32)
    labels = toks.copy()
    labels[:, -3:] = -1
    frames = rng.standard_normal((B, frames_len or cfg.frontend_len, cfg.d_model))
    frames = frames.astype(np.float32)
    arrays = {"tokens": toks, "labels": labels, "frames": frames}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# -- cross-attention --------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_matches_reference(dtype):
    """`apply_attn(memory=)`: q from the normed x, k and v from the memory
    as it is, no rope (the positions are ignored), non-causal, no cache."""
    rcfg, pcfg = _cfgs(dtype=dtype)
    rparams = rnn.init_tree(rblocks.desc_attn(rcfg), jax.random.key(3))
    pparams = _from_ref(rparams)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 7, pcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 19, pcfg.d_model)).astype(np.float32)
    (rx, px), (rm, pm) = _both(x, dtype), _both(mem, dtype)
    pos = np.arange(7)[None, :] + 5
    ry, rc = rblocks.apply_attn(rparams, rx, jnp.asarray(pos), rcfg, memory=rm)
    py, pc = pblocks.apply_attn(pparams, px, torch.from_numpy(pos), pcfg, memory=pm)
    assert rc is None and pc is None
    assert py.dtype == px.dtype and tuple(py.shape) == x.shape
    _close_dtype(py, ry, dtype)
    # no rope on the memory path: other positions give the same output
    again, _ = pblocks.apply_attn(pparams, px, torch.zeros((1, 7), dtype=torch.int64), pcfg,
                                  memory=pm)
    assert torch.equal(again, py)


# -- the encoder ------------------------------------------------------------


@pytest.mark.parametrize("frames_len,chunk", [(16, None), (40, 16)])
def test_encode_matches_reference(frames_len, chunk, monkeypatch):
    """The config's 16 frames, and 40 frames with the query chunk at 16:
    the non-causal encoder's queries run in three chunks, each against
    every frame (the causal triangle truncation must not apply)."""
    if chunk:
        monkeypatch.setattr(rnn, "ATTN_Q_CHUNK", chunk)
        monkeypatch.setattr(pnn, "ATTN_Q_CHUNK", chunk)
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    rb, pb = _batch(pmodel.cfg, 1, frames_len=frames_len)
    rmem = rmodel.encode(rparams, rb["frames"])
    pmem = pmodel.encode(pparams, pb["frames"])
    assert pmem.dtype == torch.float32 and tuple(pmem.shape) == (B, frames_len, 128)
    _close(pmem, rmem, F32_ATOL, F32_RTOL)
    if chunk:  # every query sees the last frame: the chunked path is not causal
        late = pb["frames"].clone()
        late[:, -1] += 1.0
        assert not torch.allclose(pmodel.encode(pparams, late)[:, 0], pmem[:, 0])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_logits_and_loss_match_reference(dtype):
    rmodel, rparams, pmodel, pparams = _pair(dtype=dtype)
    rb, pb = _batch(pmodel.cfg, 0)
    rl, rc = rmodel.forward(rparams, rb)
    pl, pc = pmodel.forward(pparams, pb)
    assert rc is None and pc is None
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (B, L, pmodel.cfg.vocab)
    rloss, rm = rmodel.loss(rparams, rb)
    ploss, pm = pmodel.loss(pparams, pb)
    assert float(pm["tokens"]) == float(rm["tokens"]) == B * (L - 3)
    if dtype == "float32":
        _close(pl, rl, F32_ATOL, F32_RTOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    else:
        _close(pl, rl, BF16_ATOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-3)


def test_forward_without_frames_or_cache_raises():
    _, _, pmodel, pparams = _pair(dtype="float32")
    with pytest.raises(ValueError, match="frames"):
        pmodel.forward(pparams, {"tokens": torch.zeros((B, 3), dtype=torch.int32)})


# -- the cache --------------------------------------------------------------


def _specs(tree, path=""):
    """{path: (shape, dtype name)} of a cache (or spec) tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_specs(tree[k], f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("dtype,kv_quant,enc_len", [("bfloat16", False, None),
                                                     ("float32", False, None),
                                                     ("float32", True, 24)])
def test_cache_desc_matches_reference(dtype, kv_quant, enc_len):
    """pos, memory (B, enc_len, d_model) in the compute dtype, and the
    decoder's per-layer self-attention K/V (also the int8 form) stacked
    without a per-layer 'len'."""
    rcfg, pcfg = _cfgs(dtype=dtype, kv_quant=kv_quant)
    want = _specs(r_build_model(rcfg).cache_desc(3, 20, enc_len))
    got = _specs(build_model(pcfg, device="cpu").cache_desc(3, 20, enc_len))
    assert got == want
    assert got["/memory"][0] == (3, enc_len or pcfg.frontend_len, pcfg.d_model)
    assert "/blocks/len" not in got
    assert _specs(build_model(pcfg, device="cpu").init_cache(3, 20)) == _specs(
        r_build_model(rcfg).init_cache(3, 20))


def test_cached_decode_matches_reference_and_parallel():
    """8 tokens one at a time through the cache, frames with the first
    (as tests/test_arch_smoke.py drives the reference): every step's logits
    within the cache tolerance of the reference's, the memory written into
    the cache in place and read back by the later steps, and the whole
    within 1e-2 * max|logit| of the parallel forward (bfloat16 K/V)."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    rb, pb = _batch(pmodel.cfg, 2)
    full, _ = pmodel.forward(pparams, pb)
    rcache, pcache = rmodel.init_cache(B, 16), pmodel.init_cache(B, 16)
    memory = pcache["memory"]
    outs = []
    for t in range(8):
        rs = {"tokens": rb["tokens"][:, t:t + 1]}
        ps = {"tokens": pb["tokens"][:, t:t + 1]}
        if t == 0:
            rs["frames"], ps["frames"] = rb["frames"], pb["frames"]
        rl, rcache = rmodel.forward(rparams, rs, rcache)
        pl, pcache = pmodel.forward(pparams, ps, pcache)
        _close(pl, rl, DECODE_ATOL)
        assert int(pcache["pos"]) == int(rcache["pos"]) == t + 1
        assert pcache["memory"] is memory
        outs.append(pl)
    _close(pcache["memory"], rcache["memory"], F32_ATOL, F32_RTOL)
    _close(pcache["memory"], pmodel.encode(pparams, pb["frames"]), 0.0)
    # the same rows written: bfloat16 values within two roundings of each
    # other (a rounding flip in layer 0's cache reaches the later layers' keys)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(pcache["blocks"][key]), _np(rcache["blocks"][key]),
                                   rtol=2.0**-6, atol=1e-3)
    assert _specs(pcache) == _specs(rcache)
    _close(torch.cat(outs, dim=1), full[:, :8], 1e-2)


def test_prefill_and_greedy_decode_match_reference():
    """`make_prefill_step` with frames, then 6 greedy decode steps reading
    the cached memory: equal token streams, logits within the cache
    tolerance."""
    from repro_torch.runtime import steps

    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    rb, pb = _batch(pmodel.cfg, 3)
    rb = {k: rb[k] for k in ("tokens", "frames")}
    pb = {k: pb[k] for k in ("tokens", "frames")}
    rl, rcache = rsteps.make_prefill_step(rmodel)(rparams, rb, rmodel.init_cache(B, 24))
    pl, pcache = steps.make_prefill_step(pmodel)(pparams, pb, pmodel.init_cache(B, 24))
    _close(pl, rl, DECODE_ATOL)
    rdec, pdec = jax.jit(rsteps.make_decode_step(rmodel)), steps.make_decode_step(pmodel)
    rn = jnp.argmax(rl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    pn = torch.argmax(pl[:, -1], dim=-1)[:, None].to(torch.int32)
    rtoks, ptoks = [], []
    for _ in range(6):
        assert np.array_equal(pn.numpy(), np.asarray(rn))
        rtoks.append(np.asarray(rn))
        ptoks.append(pn.numpy())
        rn, rcache = rdec(rparams, rn, rcache)
        pn, pcache = pdec(pparams, pn, pcache)
    assert int(pcache["pos"]) == int(rcache["pos"]) == L + 6


def test_run_static_matches_reference_stream():
    """`launch.serve.run_static` on the reduced model at float32: the
    frames drawn after the prompts from the same numpy generator, so the
    greedy token stream equals the reference's prefill + decode on the same
    weights and draws."""
    rmodel, rparams, pmodel, pparams = _pair(dtype="float32")
    args = serve.parse_args(["--arch", SEAMLESS, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "6", "--gen", "5"])
    out = serve.run_static(args, pmodel.cfg, pmodel, pparams)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, pmodel.cfg.vocab, (2, 6))
    frames = rng.standard_normal((2, pmodel.cfg.frontend_len, pmodel.cfg.d_model))
    batch = {"tokens": jnp.asarray(prompts, jnp.int32), "frames": jnp.asarray(frames, jnp.float32)}
    rl, rcache = rsteps.make_prefill_step(rmodel)(rparams, batch, rmodel.init_cache(2, 11))
    nxt = jnp.argmax(rl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [nxt]
    rdec = jax.jit(rsteps.make_decode_step(rmodel))
    for _ in range(4):
        nxt, rcache = rdec(rparams, nxt, rcache)
        want.append(nxt)
    assert np.array_equal(out["tokens"], np.concatenate([np.asarray(w) for w in want], axis=1))


def test_serve_on_cpu_and_continuous_refused():
    """`launch.serve --smoke` serves the encoder-decoder on the contiguous
    cache; `--continuous` refuses it (no paged cache), as the reference's
    does."""
    argv = ["--arch", SEAMLESS, "--smoke", "--device", "cpu"]
    out = serve.main(argv + ["--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["tokens"].dtype == np.int32
    assert 0 <= out["tokens"].min() and out["tokens"].max() < 512
    with pytest.raises(ValueError, match="paged"):
        serve.main(argv + ["--continuous"])


# -- remat ------------------------------------------------------------------


def test_remat_gradients_equal_plain_ones(monkeypatch):
    """Under autograd each encoder and decoder layer runs under a
    non-reentrant `torch.utils.checkpoint` (cfg.remat): the loss and every
    gradient equal those without it bit for bit; a forward without
    autograd takes no checkpoint."""
    import repro_torch.models.model as pmodel_mod

    _, _, pmodel, pparams = _pair(dtype="float32")
    _, pb = _batch(pmodel.cfg, 5)
    calls = []
    real = pmodel_mod.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(pmodel_mod, "checkpoint", counted)
    leaves, treedef = pytree.flatten_with_path(pparams)

    def grads(model):
        tracked = [p.detach().requires_grad_(True) for _, p in leaves]
        loss, _ = model.loss(pytree.unflatten(treedef, tracked), pb)
        return loss, torch.autograd.grad(loss, tracked)

    l1, g1 = grads(pmodel)
    cfg = pmodel.cfg
    assert calls == [False] * (cfg.n_enc_layers + cfg.n_layers)
    l0, g0 = grads(build_model(cfg.scaled(remat=False), device="cpu"))
    assert torch.equal(l1, l0)
    for (path, _), a, b in zip(leaves, g1, g0):
        assert torch.equal(a, b), pytree.leaf_name(path)
    calls.clear()
    with torch.no_grad():
        pmodel.loss(pparams, pb)
    assert calls == []
