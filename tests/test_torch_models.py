"""The port's model zoo (`repro_torch.models`, `repro_torch.configs`)
against the live reference (`repro.models`, `repro.configs`) on the CPU,
at `reduced_for_smoke` sizes, with the reference's weights carried across
by `nn.params_from_reference`.

Tolerances, each with its reason:

* float32 configs, no cache: logits within rtol 1e-4 and atol
  1e-5 * max|logit| (the same float32 math; sums in other orders, and
  XLA's `rsqrt`, `pow`, `cos`, `sin` a few ulps from torch's). Losses to
  rtol 1e-5.
* bfloat16 configs: atol 1.5e-2 * max|logit| (every activation rounds to
  bfloat16 after each op; the two packages' matmuls round their float32
  sums at different points).
* Decode through a cache: atol 1e-3 * max|logit|. Every config stores
  K/V in bfloat16, so a float32 key an ulp away from a bfloat16 rounding
  midpoint in one package rounds to the other neighbour in the other; the
  attention logits move by that much.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.runtime import steps

DENSE = ["smollm-360m", "starcoder2-7b", "minitron-4b"]  # swiglu, gelu, relu2
BUILDABLE = {"smollm-360m", "phi4-mini-3.8b", "starcoder2-7b", "minitron-4b", "internvl2-76b",
             "llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b",
             "seamless-m4t-large-v2"}
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

def _pair(name, seed=0, **over):
    """(reference model, reference params, port model, port params) of the
    reduced config, the port's weights copied from the reference's."""
    rcfg = r_reduced(r_get_config(name)).scaled(**over)
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(seed))
    pmodel = build_model(reduced_for_smoke(get_config(name)).scaled(**over), device="cpu")
    pparams = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


def _tokens(cfg, seed, shape=(B, L)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _close(port, ref, atol_rel, rtol=0.0):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=atol_rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    assert ARCHS == R_ARCHS
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(r_get_config(name))
    assert dataclasses.asdict(reduced_for_smoke(get_config(name))) == dataclasses.asdict(
        r_reduced(r_get_config(name)))


def _desc_leaves(tree, is_leaf):
    out = {}

    def walk(node, path):
        if is_leaf(node):
            out[path] = node
        else:
            for k in node:
                walk(node[k], f"{path}/{k}")

    walk(tree, "")
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_desc_matches_reference(name):
    """Every family (dense, MoE, MLA, xLSTM, the hybrid, the
    encoder-decoder) builds and declares the reference's parameter tree
    (keys, shapes, axes, inits)."""
    assert set(ARCHS) == BUILDABLE
    cfg = reduced_for_smoke(get_config(name))
    ref = _desc_leaves(r_build_model(r_reduced(r_get_config(name))).desc(), rnn.is_desc)
    port = _desc_leaves(build_model(cfg, device="cpu").desc(), pnn.is_desc)
    assert sorted(port) == sorted(ref)
    for path, p in port.items():
        r = ref[path]
        assert (p.shape, p.axes, p.init, p.scale) == (r.shape, r.axes, r.init, r.scale), path
        assert p.dtype == torch.float32 and r.dtype == jnp.float32


def test_init_tree_draws_from_the_generator():
    model = build_model(reduced_for_smoke(get_config("smollm-360m")), device="cpu")
    a = pnn.init_tree(model.desc(), torch.Generator().manual_seed(3), device="cpu")
    b = pnn.init_tree(model.desc(), torch.Generator().manual_seed(3), device="cpu")
    c = pnn.init_tree(model.desc(), torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])
    assert torch.equal(a["blocks"]["attn"]["norm"], torch.ones_like(a["blocks"]["attn"]["norm"]))
    wq = a["blocks"]["attn"]["wq"]  # (layers, d, h*dh): fan-in d * layers
    assert wq.dtype == torch.float32
    assert abs(float(wq.std()) * np.sqrt(np.prod(wq.shape[:-1])) - 1.0) < 0.05
    assert abs(float(a["embed"].std()) / 0.02 - 1.0) < 0.05


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_for_smoke(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn.params_from_reference({"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_and_loss_match_reference(name, dtype):
    rmodel, rparams, pmodel, pparams = _pair(name, dtype=dtype)
    toks = _tokens(pmodel.cfg, 0)
    labels = toks.copy()
    labels[:, -3:] = -1  # masked positions
    rl, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    pl, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (B, L, pmodel.cfg.vocab)
    rloss, rm = rmodel.loss(rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    ploss, pm = pmodel.loss(pparams, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    assert float(pm["tokens"]) == float(rm["tokens"]) == B * (L - 3)
    if dtype == "float32":
        _close(pl, rl, F32_ATOL, F32_RTOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    else:
        _close(pl, rl, BF16_ATOL)
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-3)


def test_vision_stub_matches_reference():
    """internvl2's decoder: precomputed patch embeddings projected and put
    in front of the tokens; the loss reads only the token part."""
    rmodel, rparams, pmodel, pparams = _pair("internvl2-76b", dtype="float32")
    cfg = pmodel.cfg
    toks = _tokens(cfg, 1)
    pe = np.random.default_rng(1).standard_normal((B, cfg.frontend_len, cfg.d_model))
    pe = pe.astype(np.float32)
    rb = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe), "labels": jnp.asarray(toks)}
    pb = {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(pe),
          "labels": torch.from_numpy(toks)}
    rl, _ = rmodel.forward(rparams, rb)
    pl, _ = pmodel.forward(pparams, pb)
    assert tuple(pl.shape) == (B, cfg.frontend_len + L, cfg.vocab)
    _close(pl, rl, F32_ATOL, F32_RTOL)
    np.testing.assert_allclose(float(pmodel.loss(pparams, pb)[0]),
                               float(rmodel.loss(rparams, rb)[0]), rtol=1e-5)


def test_chunked_attention_in_forward_matches_reference(monkeypatch):
    """A prompt longer than ATTN_Q_CHUNK runs the query-chunked path (with
    the static causal KV truncation) in both packages."""
    monkeypatch.setattr(rnn, "ATTN_Q_CHUNK", 16)
    monkeypatch.setattr(pnn, "ATTN_Q_CHUNK", 16)
    rmodel, rparams, pmodel, pparams = _pair("smollm-360m", dtype="float32")
    toks = _tokens(pmodel.cfg, 2)
    rl, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    pl, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    _close(pl, rl, F32_ATOL, F32_RTOL)


ATTN_CASES = {
    "direct": dict(),
    "window": dict(window=9),
    "chunked": dict(q_chunk=8),
    "chunked-window": dict(q_chunk=8, window=150),
    "chunked-offset": dict(q_chunk=8, q_offset=130),
    "kv-len": dict(q_offset=jnp.int32(3), kv_len=jnp.int32(30)),
    "chunked-kv-len": dict(q_chunk=8, q_offset=jnp.int32(2), kv_len=jnp.int32(33)),
    "per-slot": dict(q_offset=np.asarray([0, 5], np.int32), kv_len=np.asarray([19, 33], np.int32)),
    "non-causal": dict(causal=False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    kw = ATTN_CASES[case]
    rng = np.random.default_rng(5)
    lq, lk = 20, (150 if case == "chunked-offset" else 40)
    q = rng.standard_normal((B, lq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, lk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, lk, 2, 16)).astype(np.float32)
    rkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a) for n, a in kw.items()}
    pkw = {n: (torch.as_tensor(np.array(a)) if isinstance(a, (np.ndarray, jnp.ndarray))
               else a) for n, a in kw.items()}
    ref = rnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **rkw)
    port = pnn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **pkw)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cached_decode_matches_parallel_and_reference(kv_quant):
    """Token-by-token decode through the contiguous cache (bfloat16, or
    int8 with scales) equals the parallel forward (as
    tests/test_arch_smoke.py holds the reference), and the reference's
    decode step by step."""
    rmodel, rparams, pmodel, pparams = _pair("smollm-360m", dtype="float32", kv_quant=kv_quant)
    toks = _tokens(pmodel.cfg, 3, (B, 12))
    full, _ = pmodel.forward(pparams, {"tokens": torch.from_numpy(toks)})
    rdecode = jax.jit(rmodel.decode_step)
    pcache = pmodel.init_cache(B, 16)
    rcache = rmodel.init_cache(B, 16)
    assert {k: tuple(v.shape) for k, v in pcache["blocks"].items()} == {
        k: tuple(v.shape) for k, v in rcache["blocks"].items()}
    outs = []
    for t in range(toks.shape[1]):
        lg, pcache = pmodel.decode_step(pparams, torch.from_numpy(toks[:, t:t + 1]), pcache)
        rlg, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), rcache)
        assert int(pcache["pos"]) == t + 1
        _close(lg, rlg, DECODE_ATOL)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    scale = float(full.abs().max())
    # bf16 (or int8) keys and values against the float32 parallel forward
    assert float((dec - full).abs().max()) / scale < (0.05 if kv_quant else 0.02)


def test_ring_buffer_wraps_like_reference():
    """Past its capacity the contiguous cache is a ring buffer (the
    windowed long-context decode): the write index wraps and clamps as
    `dynamic_update_slice` does."""
    rmodel, rparams, pmodel, pparams = _pair("smollm-360m", dtype="float32", attn_window=6)
    toks = _tokens(pmodel.cfg, 4, (B, 14))
    rdecode = jax.jit(rmodel.decode_step)
    pcache, rcache = pmodel.init_cache(B, 8), rmodel.init_cache(B, 8)
    for t in range(toks.shape[1]):
        lg, pcache = pmodel.decode_step(pparams, torch.from_numpy(toks[:, t:t + 1]), pcache)
        rlg, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), rcache)
        _close(lg, rlg, DECODE_ATOL)
    # the same rows written: bfloat16 values within two roundings of each
    # other (a rounding flip in layer 0's cache reaches layer 1's keys)
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache["blocks"][key].float().numpy(),
                                   np.asarray(rcache["blocks"][key]).astype(np.float32),
                                   rtol=2.0**-6, atol=1e-3)


def test_paged_decode_matches_reference():
    """The paged branch: per-slot clocks and page tables over a shared
    arena, slots at different depths, a dead slot on scratch page 0."""
    rmodel, rparams, pmodel, pparams = _pair("smollm-360m", dtype="float32")
    cfg = pmodel.cfg
    slots, pages, pt, max_pages = 3, 9, 4, 3
    ptab = np.asarray([[3, 1, 7], [2, 5, 0], [0, 0, 0]], np.int32)  # slot 2 dead
    lens = np.asarray([5, 2, 0], np.int32)
    rng = np.random.default_rng(6)
    pcache = pmodel.init_paged_cache(slots, pages, pt, max_pages)
    rcache = rmodel.init_paged_cache(slots, pages, pt, max_pages)
    assert {k: tuple(v.shape) for k, v in pcache["blocks"].items()} == {
        k: tuple(v.shape) for k, v in rcache["blocks"].items()}
    # the same prior context in both arenas
    for key in ("k", "v"):
        ctx = rng.standard_normal(tuple(pcache["blocks"][key].shape)).astype(np.float32)
        rcache["blocks"][key] = jnp.asarray(ctx).astype(jnp.bfloat16)
    pcache["blocks"] = pnn.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache["blocks"]), device="cpu")
    rdecode = jax.jit(rmodel.decode_step)
    for t in range(6):
        tok = rng.integers(0, cfg.vocab, (slots, 1)).astype(np.int32)
        pcache["pos"], pcache["page_table"] = torch.from_numpy(lens), torch.from_numpy(ptab)
        rcache["pos"], rcache["page_table"] = jnp.asarray(lens), jnp.asarray(ptab)
        lg, pcache = pmodel.decode_step(pparams, torch.from_numpy(tok), pcache)
        rlg, rcache = rdecode(rparams, jnp.asarray(tok), rcache)
        _close(lg[:2], np.asarray(rlg)[:2], DECODE_ATOL)  # live slots
        assert np.array_equal(pcache["pos"].numpy(), lens + 1)
        lens = lens + np.asarray([1, 1, 0], np.int32)
    live = np.asarray(sorted({int(p) for p in ptab[:2].ravel()} - {0}))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            pcache["blocks"][key][:, live].float().numpy(),
            np.asarray(rcache["blocks"][key][:, live]).astype(np.float32), rtol=0, atol=2e-2)


def test_paged_cache_rejects_prefill():
    _, _, pmodel, pparams = _pair("smollm-360m", dtype="float32")
    cache = pmodel.init_paged_cache(1, 4, 4, 2)
    with pytest.raises(ValueError, match="decode-only"):
        pmodel.forward(pparams, {"tokens": torch.zeros((1, 3), dtype=torch.int32)}, cache)


def test_steps_match_reference():
    """make_prefill_step / make_decode_step (greedy) against the
    reference's; sampling draws from the given generator."""
    from repro.runtime import steps as rsteps

    rmodel, rparams, pmodel, pparams = _pair("starcoder2-7b", dtype="float32")
    toks = _tokens(pmodel.cfg, 7, (B, 10))
    rpre, ppre = rsteps.make_prefill_step(rmodel), steps.make_prefill_step(pmodel)
    rlg, rcache = rpre(rparams, {"tokens": jnp.asarray(toks)}, rmodel.init_cache(B, 16))
    plg, pcache = ppre(pparams, {"tokens": torch.from_numpy(toks)}, pmodel.init_cache(B, 16))
    assert tuple(plg.shape) == (B, 1, pmodel.cfg.vocab)
    _close(plg, rlg, F32_ATOL, F32_RTOL)
    nxt = torch.argmax(plg[:, -1], dim=-1)[:, None].to(torch.int32)
    rdec, pdec = rsteps.make_decode_step(rmodel), steps.make_decode_step(pmodel)
    rn, _ = rdec(rparams, jnp.asarray(nxt.numpy()), rcache)
    pn, _ = pdec(pparams, nxt, pcache)
    assert pn.dtype == torch.int32 and np.array_equal(pn.numpy(), np.asarray(rn))
    sampler = steps.make_decode_step(pmodel, sample=True, temperature=0.7)
    draws = [sampler(pparams, nxt, pmodel.init_cache(B, 16), torch.Generator().manual_seed(9))[0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < pmodel.cfg.vocab
