"""The port's serving tier (`repro_torch.runtime.batcher`,
`repro_torch.launch.serve`, `core.policy.request_kv_name`) on the CPU: the
contracts of tests/test_batcher.py restated on the port, and the port's
token streams and page accounting against the live reference's batcher
on the same weights and requests.

The cross-package runs use float32 configs. Their token streams must be
equal; each token compared is backed by a top-2 logit margin of more than
twice the float32 logits tolerance of tests/test_torch_models.py
(1.1e-4 * max|logit|), so equality is not decided on a near tie.
"""

import argparse
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import policy as r_policy
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro.runtime import batcher as rbatch
from repro_torch.configs import get_config
from repro_torch.core import policy as p_policy
from repro_torch.core.policy import Policy, serving_policies
from repro_torch.launch import serve
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.runtime import kvcomp
from repro_torch.runtime.batcher import ContinuousBatcher, Request

MARGIN = 2 * 1.1e-4  # twice the float32 logits tolerance, relative to max|logit|



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are tiny, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@functools.cache
def _setup(dtype="bfloat16", arch="smollm-360m", n_layers=2, n_dense=None):
    """The reference's test model (smollm-360m reduced, 2 layers, key 0), or
    another reduced `arch` (with `n_dense` leading dense layers for an MoE
    one), in both packages, the port's weights copied from the reference's."""
    rcfg = r_reduced(r_get_config(arch)).scaled(n_layers=n_layers, dtype=dtype)
    cfg = reduced_for_smoke(get_config(arch)).scaled(n_layers=n_layers, dtype=dtype)
    if n_dense is not None:
        rcfg = rcfg.scaled(moe=dataclasses.replace(rcfg.moe, n_dense_layers=n_dense))
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, n_dense_layers=n_dense))
    rmodel = r_build_model(rcfg)
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(0))
    model = build_model(cfg, device="cpu")
    params = pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return cfg, model, params, rmodel, rparams


def _prompts(cfg, seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, length).astype(np.int32) for _ in range(n)]


def _single_stream(model, params, prompt, n):
    """Greedy single-request decode through the contiguous cache."""
    cache = model.init_cache(1, 32)
    logits, cache = model.forward(params, {"tokens": torch.from_numpy(prompt)[None]}, cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        lg, cache = model.forward(
            params, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)}, cache)
        toks.append(int(torch.argmax(lg[0, -1])))
    return toks


# -- the reference's contracts (tests/test_batcher.py), on the port ---------


def test_batcher_matches_single_stream():
    cfg, model, params, _, _ = _setup()
    prompts = _prompts(cfg, 0, 3, 8)
    b = ContinuousBatcher(model, params, slots=4, max_len=32, eos_id=-1)
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    b.run(reqs)
    assert all(r.done for r in reqs)
    for r in reqs:
        assert r.out == _single_stream(model, params, r.prompt, 5), r.rid


def test_batcher_waves_reuse_slots():
    cfg, model, params, _, _ = _setup()
    reqs = [Request(rid=i, prompt=p, max_new=3) for i, p in enumerate(_prompts(cfg, 1, 5, 8))]
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1)
    b.run(reqs)
    assert all(r.done and len(r.out) == 3 for r in reqs)


@pytest.mark.parametrize("paged", [True, False])
def test_max_new_counts_emitted_tokens(paged):
    """max_new=N yields exactly N tokens (the prefill token counts)."""
    cfg, model, params, _, _ = _setup()
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(_prompts(cfg, 2, 3, 8))]
    b = ContinuousBatcher(model, params, slots=4, max_len=32, eos_id=-1, paged=paged)
    assert b.paged == paged
    b.run(reqs)
    for r in reqs:
        assert r.done and len(r.out) == 5, (r.rid, r.out)


@pytest.mark.parametrize("paged", [True, False])
def test_eos_at_prefill_terminates_at_admission(paged):
    """A request whose first emitted token is EOS finishes at admission
    without occupying a decode slot or, paged, any pages."""
    cfg, model, params, _, _ = _setup()
    prompt = _prompts(cfg, 3, 1, 8)[0]
    first_tok, _ = ContinuousBatcher(model, params, slots=1, max_len=32, eos_id=-1)._prefill(prompt)
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=first_tok, paged=paged)
    req = Request(rid=0, prompt=prompt, max_new=8)
    assert b.try_admit(req)
    assert req.done and req.out == [first_tok]
    assert not b.live.any()
    if paged:
        assert len(b.free_pages) == b.arena_pages
    assert b.step() == []


def test_paged_mid_wave_admission():
    """Per-slot clocks admit a request while another is mid-decode; the
    legacy shared-clock cache refuses exactly this."""
    cfg, model, params, _, _ = _setup()
    p0, p1 = _prompts(cfg, 4, 2, 8)
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1)
    assert b.paged
    assert b.try_admit(Request(rid=0, prompt=p0, max_new=10))
    for _ in range(3):
        b.step()
    r1 = Request(rid=1, prompt=p1, max_new=5)
    assert b.try_admit(r1)  # joins at clock 8 while slot 0 sits at 11
    b.run([])
    assert r1.done and r1.out == _single_stream(model, params, p1, 5)
    bl = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, paged=False)
    assert bl.try_admit(Request(rid=0, prompt=p0, max_new=10))
    bl.step()
    assert not bl.try_admit(Request(rid=1, prompt=p1, max_new=5))


def test_paged_decode_matches_single_stream():
    """Paged decode (page-table gather, per-slot clocks) reproduces the
    single-request contiguous decode token for token."""
    cfg, model, params, _, _ = _setup()
    b = ContinuousBatcher(model, params, slots=4, max_len=32, eos_id=-1, page_tokens=8)
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(_prompts(cfg, 5, 3, 8))]
    b.run(reqs)
    for r in reqs:
        assert r.out == _single_stream(model, params, r.prompt, 6), r.rid


def test_paged_evict_restore_parity_under_pressure():
    """Compress-on-evict / decompress-on-hit at Policy.raw is invisible:
    a page-starved arena (forced LIFO preemption) decodes the token streams
    of a pressure-free one."""
    cfg, model, params, _, _ = _setup()
    prompts = _prompts(cfg, 6, 4, 12)

    def run(arena_pages):
        b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                              arena_pages=arena_pages, policies=Policy.raw())
        reqs = [Request(rid=i, prompt=p, max_new=20) for i, p in enumerate(prompts)]
        b.run(reqs)
        return reqs, b

    ref, calm = run(None)
    cur, tight = run(5)
    assert calm.stats["evictions"] == 0
    assert tight.stats["evictions"] > 0 and tight.stats["restores"] > 0
    for a, c in zip(ref, cur):
        assert a.done and c.done and len(c.out) == 20
        assert a.out == c.out, a.rid


def test_paged_policyset_resolved_per_request():
    """Admission resolves each request's contract once from the PolicySet:
    long contexts get the fixed_ratio budget, short ones stay raw, and a
    lossy serving run still completes."""
    cfg, model, params, _, _ = _setup()
    rng = np.random.default_rng(7)
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                          arena_pages=5, policies=serving_policies(8.0), long_threshold=24)
    short = Request(rid=0, prompt=rng.integers(1, cfg.vocab, 4).astype(np.int32), max_new=8)
    long = Request(rid=1, prompt=rng.integers(1, cfg.vocab, 12).astype(np.int32), max_new=20)
    b.run([short, long])
    assert short.policy.mode == "raw" and short.pname == "kv/short/0"
    assert long.policy.mode == "fixed_ratio" and long.pname == "kv/long/1"
    assert short.done and long.done and len(short.out) == 8 and len(long.out) == 20


def test_lossy_restores_within_bound_of_evicted_stack():
    """Under page pressure with long (fixed_ratio) requests, every page
    stack restored is within its bound of the stack evicted (plus the
    bfloat16 rounding of the arena)."""
    cfg, model, params, _, _ = _setup()
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                          arena_pages=5, policies=serving_policies(8.0), long_threshold=24)
    reqs = [Request(rid=i, prompt=p, max_new=20) for i, p in enumerate(_prompts(cfg, 6, 4, 12))]
    evicted, restored = {}, []
    compress, decompress = kvcomp.compress_page, kvcomp.decompress_page

    def spy_compress(page, policy, **kw):
        cp = compress(page, policy, **kw)
        evicted[id(cp)] = page.clone()
        return cp

    def spy_decompress(cp, **kw):
        out = decompress(cp, **kw)
        restored.append((cp, evicted[id(cp)], out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kvcomp, "compress_page", spy_compress)
        mp.setattr(kvcomp, "decompress_page", spy_decompress)
        b.run(reqs)
    assert all(r.done and len(r.out) == 20 and r.policy.mode == "fixed_ratio" for r in reqs)
    assert b.stats["restores"] > 0 and restored
    assert all(cp.codec == "bot" for cp, _, _ in restored)
    for cp, page, out in restored:
        assert out.dtype == page.dtype == torch.bfloat16 and out.shape == page.shape
        err = (out.float() - page.float()).abs()
        assert bool((err <= cp.eb + 2.0**-8 * out.float().abs()).all())


def test_batcher_rejects_bad_configurations():
    cfg, model, params, _, _ = _setup()
    with pytest.raises(ValueError, match="max_pages"):
        ContinuousBatcher(model, params, slots=2, max_len=32, page_tokens=8, arena_pages=3)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(model, params, slots=2, max_len=32, paged=False, policies=Policy.raw())
    b = ContinuousBatcher(model, params, slots=1, max_len=16, page_tokens=8)
    with pytest.raises(ValueError, match="max_pages"):
        b.try_admit(Request(rid=0, prompt=np.ones(16, np.int32), max_new=2))


# -- the port against the reference -----------------------------------------


class _Recorder:
    """A model whose forward keeps its last position's logits."""

    def __init__(self, model):
        self.model, self.cfg, self.device, self.last = model, model.cfg, model.device, None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def forward(self, params, batch, cache=None):
        logits, cache = self.model.forward(params, batch, cache)
        self.last = logits[:, -1]
        return logits, cache


class _MarginBatcher(ContinuousBatcher):
    """The port's batcher, noting the relative top-2 logit margin behind
    every token it emits (prefill and live decode rows)."""

    def __init__(self, model, *args, **kw):
        super().__init__(_Recorder(model), *args, **kw)
        self.margins = []

    def _note(self, rows):
        top = torch.topk(rows, 2, dim=-1).values
        self.margins += ((top[:, 0] - top[:, 1]) / rows.abs().amax(-1)).tolist()

    def _prefill(self, prompt):
        out = super()._prefill(prompt)
        self._note(self.model.last)
        return out

    def _decode(self, params, tokens, cache):
        live = torch.from_numpy(self.live.copy())
        out = super()._decode(params, tokens, cache)
        self._note(self.model.last[live])
        return out


def _drive(b, reqs):
    """`run`'s loop, sampling resident KV bytes after every iteration."""
    pending, resident = list(reqs), []
    while pending or b.preempted or b.live.any():
        while b.preempted and b.try_admit(b.preempted[0]):
            b.preempted.pop(0)
        while pending and b.try_admit(pending[0]):
            pending.pop(0)
        b.step()
        resident.append(b.resident_kv_bytes())
    return resident


LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
ZAMBA2, XLSTM = "zamba2-1.2b", "xlstm-1.3b"
SCENARIOS = {
    "paged": dict(kw=dict(slots=4, max_len=32, page_tokens=8), max_new=6),
    "legacy": dict(kw=dict(slots=4, max_len=32, paged=False), max_new=6),
    "tight-raw": dict(kw=dict(slots=2, max_len=32, page_tokens=8, arena_pages=5),
                      policies="raw", max_new=20),
    "serving": dict(kw=dict(slots=2, max_len=32, page_tokens=8, arena_pages=5,
                            long_threshold=24), policies="serving", max_new=20),
    # the MoE decoder under page pressure with lossy (K6) evictions
    "moe-serving": dict(model=dict(arch=LLAMA4), kw=dict(
        slots=2, max_len=32, page_tokens=8, arena_pages=5, long_threshold=24),
        policies="serving", max_new=20),
    # a leading dense layer: the `dense_blocks` arenas evict and restore too
    "moe-dense-layers-serving": dict(model=dict(arch=LLAMA4, n_layers=3, n_dense=1), kw=dict(
        slots=2, max_len=32, page_tokens=8, arena_pages=5, long_threshold=24),
        policies="serving", max_new=20),
    # MLA (latent cache) with a leading dense layer on the legacy cache:
    # 4 requests on 2 slots, admitted as the shared clock allows
    "mla-legacy-waves": dict(model=dict(arch=DEEPSEEK, n_layers=3), kw=dict(
        slots=2, max_len=32), max_new=6),
    # the recurrent families (no paged cache) at their reduced depth on the
    # legacy cache, 3 requests on 2 slots: the hybrid's (groups, layers, B,
    # ...) Mamba stacks and per-group K/V, and xLSTM's nested groups/{m,s}
    # states, spliced leaf by leaf
    "hybrid-legacy": dict(model=dict(arch=ZAMBA2, n_layers=5), kw=dict(
        slots=2, max_len=32), max_new=6, requests=3),
    "xlstm-legacy": dict(model=dict(arch=XLSTM, n_layers=4), kw=dict(
        slots=2, max_len=32), max_new=6, requests=3),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_token_streams_and_accounting_match_reference(scenario):
    """At float32, the same weights and requests give the reference's
    token streams, evictions, restores, page reuses and resident bytes
    (the lossy pages' byte counts are the kernel's exact bits on both
    sides)."""
    sc = SCENARIOS[scenario]
    cfg, model, params, rmodel, rparams = _setup("float32", **sc.get("model", {}))
    pkw, rkw = dict(sc["kw"]), dict(sc["kw"])
    if sc.get("policies") == "raw":
        pkw["policies"], rkw["policies"] = Policy.raw(), r_policy.Policy.raw()
    elif sc.get("policies") == "serving":
        pkw["policies"], rkw["policies"] = serving_policies(8.0), r_policy.serving_policies(8.0)
    prompts = _prompts(cfg, 6, sc.get("requests", 4), 12)
    rb = rbatch.ContinuousBatcher(rmodel, rparams, eos_id=-1, **rkw)
    pb = _MarginBatcher(model, params, eos_id=-1, **pkw)
    rreqs = [rbatch.Request(rid=i, prompt=p, max_new=sc["max_new"]) for i, p in enumerate(prompts)]
    preqs = [Request(rid=i, prompt=p, max_new=sc["max_new"]) for i, p in enumerate(prompts)]
    names, compress = [], kvcomp.compress_page

    def named_compress(page, policy, **kw):
        names.append(kw["name"])
        return compress(page, policy, **kw)

    r_resident = _drive(rb, rreqs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kvcomp, "compress_page", named_compress)
        p_resident = _drive(pb, preqs)
    for r, p in zip(rreqs, preqs):
        assert p.done and len(p.out) == sc["max_new"]
        assert p.out == r.out, (p.rid, p.out, r.out)
        assert (p.pname, p.evictions) == (r.pname, r.evictions)
    assert pb.stats == rb.stats
    assert p_resident == r_resident
    assert len(pb.margins) == sum(len(p.out) for p in preqs)
    assert min(pb.margins) > MARGIN
    if "policies" in sc:
        assert pb.stats["evictions"] > 0 and pb.stats["restores"] > 0
    if "n_dense" in sc.get("model", {}):
        # every arena's pages were compressed on evict, the dense layers' too
        assert pb.cache["dense_blocks"]["k"].shape[0] == 1
        assert {"k", "v", "dk", "dv"} == {n.split("/")[-1].rstrip("0123456789") for n in names}
    if scenario == "mla-legacy-waves":  # both stacks of latents were spliced
        assert not pb.paged and set(pb.cache["dense_blocks"]) == {"ckv", "krope"}
    if scenario.endswith("-legacy"):
        assert not pb.paged and not rb.paged


def test_splice_rows_takes_the_reference_axis():
    """Every leaf at any depth, along the first axis of size 1 in the
    batch-1 tree and `slots` in the main one: the batch axis of a
    (groups, blocks, B, ...) stack, and with one slot a size-1 stack axis
    (a whole copy, as the reference's rule gives); the 0-d clock stays."""
    from repro_torch.runtime.batcher import splice_rows

    def tree(b, fill):
        return {"pos": torch.tensor(7), "groups": {
            "m": {"C": torch.full((2, 1, b, 3, 4, 4), fill)},
            "s": {"h": torch.full((2, 1, b, 3, 4), fill)}}}

    main, sub = tree(3, 0.0), tree(1, 1.0)
    splice_rows(main, sub, 2, 3)
    for leaf in (main["groups"]["m"]["C"], main["groups"]["s"]["h"]):
        assert bool((leaf[:, :, 2] == 1).all()) and bool((leaf[:, :, :2] == 0).all())
    assert int(main["pos"]) == 7
    one = tree(1, 0.0)
    splice_rows(one, sub, 0, 1)  # axis 1 (blocks) has size 1 in both
    assert bool((one["groups"]["m"]["C"] == 1).all())


@pytest.mark.parametrize("threshold", [1, 24, 512])
def test_request_kv_name_matches_reference(threshold):
    for context in (0, threshold - 1, threshold, threshold + 1, 4 * threshold):
        for rid in (0, 7):
            name = p_policy.request_kv_name(rid, context, threshold)
            assert name == r_policy.request_kv_name(rid, context, threshold)
            assert name == f"kv/{'long' if context >= threshold else 'short'}/{rid}"
            assert (serving_policies(8.0).resolve(name).mode
                    == r_policy.serving_policies(8.0).resolve(name).mode)


def test_run_continuous_matches_reference_schedule():
    """`launch.serve --continuous` on the CPU: the same Poisson schedule
    as the reference's (evictions, restores and page reuses depend only on
    the prompt lengths and arrivals, since no token is EOS)."""
    from repro.launch import serve as rserve

    argv = ["--smoke", "--continuous", "--arena-pages", "4", "--slots", "2", "--requests", "6",
            "--prompt-len", "32", "--gen", "12", "--long-threshold", "24"]
    out = serve.main(argv + ["--device", "cpu"])
    args = argparse.Namespace(**{k: v for k, v in vars(serve.parse_args(argv)).items()
                                        if k != "device"})
    rcfg = r_reduced(r_get_config(args.arch))
    rmodel = r_build_model(rcfg)
    ref = rserve.run_continuous(args, rcfg, rmodel,
                                rnn.init_tree(rmodel.desc(), jax.random.key(0)))
    assert out["completed"] == 6 and out["evictions"] > 0
    for key in ("completed", "steps", "evictions", "restores", "page_reuses"):
        assert out[key] == ref[key], key
    modes = [r.policy.mode for r in out["requests"]]
    assert modes == ["raw", "fixed_ratio"] * 3
    assert all(len(r.out) == 12 for r in out["requests"])


def test_serve_static_on_cpu():
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "5"])
    assert out["tokens"].shape == (2, 5) and out["tokens"].dtype == np.int32
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


@pytest.mark.parametrize("arch", [ZAMBA2, XLSTM])
def test_serve_recurrent_families_on_cpu(arch):
    """`launch.serve --smoke` serves the hybrid and xLSTM on the contiguous
    cache; `--continuous` refuses them (no paged cache), as it refuses MLA
    and as the reference does."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    out = serve.main(argv + ["--batch", "2", "--prompt-len", "20", "--gen", "5"])
    assert out["tokens"].shape == (2, 5) and out["tokens"].dtype == np.int32
    assert 0 <= out["tokens"].min() and out["tokens"].max() < 512
    with pytest.raises(ValueError, match="paged"):
        serve.main(argv + ["--continuous"])


@pytest.mark.parametrize("arena_pages,evictions", [(136, 0), (84, 9)])
def test_full_width_serving_schedule(arena_pages, evictions):
    """The page schedule of chip_smoke.py's `[serve]` phase (phi4-mini-3.8b's
    vocabulary, prompts of 1024 and 256 tokens, 64 new each, 4 slots,
    16-token pages, long threshold 512) at a tiny width: the schedule does
    not depend on the widths, since no token is EOS. Twice a 1088-token
    context (136 pages) evicts nothing, as admission waits for free pages;
    84 pages evict nine times."""
    argv = ["--arch", "phi4-mini-3.8b", "--device", "cpu", "--continuous", "--prompt-len", "1024",
            "--gen", "64", "--slots", "4", "--page-tokens", "16", "--long-threshold", "512",
            "--arena-pages", str(arena_pages)]
    args = serve.parse_args(argv)
    cfg = get_config(args.arch).scaled(n_layers=1, d_model=32, n_heads=1, n_kv_heads=1,
                                       head_dim=32, d_ff=32)
    model = build_model(cfg, device="cpu")
    params = pnn.init_tree(model.desc(), torch.Generator().manual_seed(0), device="cpu")
    out = serve.run_continuous(args, cfg, model, params, policies=Policy.raw())
    assert out["completed"] == 8 and out["evictions"] == out["restores"] == evictions
    assert all(len(r.out) == 64 for r in out["requests"])
    if evictions:
        assert out["page_reuses"] == 554 and out["steps"] == 348
