"""The train step (`repro_torch.runtime.steps.make_train_step`) of the
families beyond the dense decoders against the live reference on the CPU:
the reduced llama4-scout-17b-a16e (MoE), deepseek-v2-236b (MLA, a dense
layer and MoE layers), zamba2-1.2b (Mamba2 SSD + shared attention),
xlstm-1.3b (mLSTM + sLSTM) and seamless-m4t-large-v2 (encoder-decoder, a
batch with frames), at their `reduced_for_smoke` sizes, batches of 4 x 64
tokens (`data.synthetic_batch`), `AdamWConfig(lr=1e-3, total_steps=100,
warmup_steps=5)`. The weights are drawn once from numpy by the
reference's descriptors (zeros, ones, normal draws times the reference's
scale) and carried to both packages.

Tolerances, each with its reason (tests/test_torch_train.py gives the
float32 and chained-step rules for the dense decoders):

* Gradients at float32: the loss to rtol 1e-5; each leaf within atol
  1e-5 * max|g_ref| plus rtol 1e-4 (the same float32 math, sums in other
  orders). One leaf is zero but for rounding in both packages: the router
  of a top-1 MoE (llama4-scout), whose renormalized gate w / w is 1
  whatever the router's logits. It is held to |g| <= 1e-6 * the model's
  largest gradient in both, and the router of the same model at top-2
  (where the gate depends on the logits) to the float32 rule.
* Gradients at bfloat16: the loss to rtol 1e-2; each leaf within atol
  max(2e-2, d) * max|g_ref|, where d is the distance between the
  reference's own bfloat16 and float32 gradients, the largest over the
  model's leaves, each over its max|g_ref| (the rule tests/test_torch_ssm.py
  applies to the hybrid's logits): through the recurrences a bfloat16
  rounding flip grows, so no port can be held closer than bfloat16 moves
  the reference itself. It binds for the hybrid and xLSTM. The routed
  experts' weights and the router of an MoE layer get 2d: a router logit
  an ulp apart sends a token to another expert, which moves that token's
  share of the gradient from one expert to another; the reference's
  bfloat16 run has such flips against its float32 run (d, 0.28 for the
  reduced deepseek-v2's experts), the port's bfloat16 run others, so the
  two lie up to 2d apart. (The reference's compiled and op-by-op bfloat16
  runs of deepseek-v2 differ by 0.17 there, ROADMAP.md section C.)
* Three chained steps at float32 with gradient compression
  (`GradCompressConfig(eb_rel=1e-3)`): losses to rtol 1e-5, grad norms to
  rtol 1e-4, wire bits to rtol 1e-3. Params within 1e-5 * max|p| plus
  2e-4 * the sum of the steps' lr per value (the gradients' rtol 1e-4
  through Adam's normalized step, a ratio of moments, at most lr a step:
  it dominates on leaves that start at zero, such as the hybrid's A_log,
  dt_bias and conv_b, whose max|p| is of the order of lr), but for at most
  `FLIP_SHARE` of a leaf's values, each off by at most 2 * the sum of the
  steps' lr: codes that flip where the two gradients straddle a rounding
  midpoint. The share is four times tests/test_torch_train.py's: the
  gradients through the hybrid's SSD recurrences and its shared attention
  and MLP, run after every group, and deepseek-v2's shared expert differ
  by more ulps than a dense layer's, and flip up to 1.2% of a leaf's
  values (the hybrid's conv_b) over three steps. A leaf
  may always have `ADAM_OUTLIERS` such values (tests/test_torch_train.py's
  count without compression): one flip is already 1.6% of the hybrid's
  64-value A_log.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import GradCompressConfig as RGradCompressConfig
from repro.runtime import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.core import pytree
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.optim import AdamWConfig, GradCompressConfig
from repro_torch.runtime import steps

FAMILIES = ["llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b",
            "seamless-m4t-large-v2"]
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=5)
SEQ, BATCH, STEPS = 64, 4, 3
F32_ATOL, F32_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
BF16_ATOL = 2e-2
#: a gradient zero but for rounding: at most this share of the model's largest
ZERO_GRAD = 1e-6
PARAM_ATOL, FLIP_SHARE, ADAM_OUTLIERS = 1e-5, 2e-2, 8
#: the routed experts' weights and the router of an MoE layer
ROUTED = {"blocks/mlp/router", "blocks/mlp/w_gate", "blocks/mlp/w_up", "blocks/mlp/w_down"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are small, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, top_k=None, **over):
    """(reference config, port config): reduced, with `over`, and with the
    MoE's `top_k` if given."""
    out = []
    for cfg in (r_reduced(r_get_config(name)), reduced_for_smoke(get_config(name))):
        if top_k:
            cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, top_k=top_k))
        out.append(cfg.scaled(**over))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(name, top_k=None):
    """The reduced model's weights as numpy, drawn by the reference's
    descriptors (`repro.models.nn.init_param`'s rule with numpy draws)."""
    rng = np.random.default_rng(0)

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

    desc = r_build_model(_cfgs(name, top_k)[0]).desc()
    return jax.tree_util.tree_map(draw, desc, is_leaf=rnn.is_desc)


def _pair(name, dtype, top_k=None):
    """(reference model, its params, port model, port params)."""
    rcfg, pcfg = _cfgs(name, top_k, dtype=dtype)
    w = _weights(name, top_k)
    return (r_build_model(rcfg), jax.tree_util.tree_map(jnp.asarray, w),
            build_model(pcfg, device="cpu"), pnn.params_from_reference(w, device="cpu"))


def _batches(cfg, n):
    """(reference batch, port batch) pairs of the same numpy draws; the
    encoder-decoder's also carry frames."""
    rcfg = RDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    pcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    out = []
    for s in range(n):
        r, p = r_synthetic_batch(rcfg, s), synthetic_batch(pcfg, s)
        assert all(np.array_equal(r[k], p[k]) for k in r)
        if cfg.encdec:
            r["frames"] = p["frames"] = np.random.default_rng(100 + s).standard_normal(
                (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(({k: jnp.asarray(v) for k, v in r.items()},
                    {k: torch.from_numpy(v) for k, v in p.items()}))
    return out


def _named(tree):
    return [(pytree.leaf_name(path), np.asarray(leaf, dtype=np.float32))
            for path, leaf in pytree.flatten_with_path(tree)[0]]


def _port_grads(model, params, batch):
    leaves, treedef = pytree.flatten_with_path(params)
    tracked = [p.detach().requires_grad_(True) for _, p in leaves]
    loss, _ = model.loss(pytree.unflatten(treedef, tracked), batch)
    grads = torch.autograd.grad(loss, tracked)
    return float(loss.detach()), pytree.unflatten(treedef, [g.float() for g in grads])


@functools.lru_cache(maxsize=None)
def _reference_run(name, dtype, top_k=None):
    """The reference on the first batches: its loss and gradients
    (`jax.value_and_grad` of `model.loss`) on the first, as named numpy
    leaves, and at float32 `STEPS` chained train steps with gradient
    compression, each step's metrics and params. One jitted program
    computes both, so each model compiles once."""
    rmodel, rparams, pmodel, _ = _pair(name, dtype, top_k)
    gc = RGradCompressConfig(eb_rel=1e-3)
    step = rsteps.make_train_step(rmodel, RAdamWConfig(**OPT), gc)
    n = STEPS if dtype == "float32" and top_k is None else 0

    @jax.jit
    def run(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(params, batch)
        return loss, grads, (step(params, opt, batch) if n else (params, opt, {}))

    opt, steps_out = rsteps.init_opt_state(rparams, gc), []
    for i, (rb, _) in enumerate(_batches(pmodel.cfg, max(n, 1))):
        loss, grads, (rparams, opt, metrics) = run(rparams, opt, rb)
        if i == 0:
            first = (float(loss), _named(grads))
        steps_out.append(({k: float(v) for k, v in metrics.items()}, _named(rparams)))
    return first, steps_out


def _reference_grads(name, dtype, top_k=None):
    return _reference_run(name, dtype, top_k)[0]


def _zero_leaves(name, cfg):
    """Leaves whose gradient is zero but for rounding (see the docstring)."""
    return {"blocks/mlp/router"} if cfg.moe is not None and cfg.moe.top_k == 1 else set()


GRAD_CASES = [(n, None) for n in FAMILIES] + [("llama4-scout-17b-a16e", 2)]


@pytest.mark.parametrize("name,top_k", GRAD_CASES,
                         ids=[n + (f"-top{k}" if k else "") for n, k in GRAD_CASES])
def test_float32_grads_match_reference(name, top_k):
    _, _, pmodel, pparams = _pair(name, "float32", top_k)
    (_, pb), = _batches(pmodel.cfg, 1)
    rloss, want = _reference_grads(name, "float32", top_k)
    ploss, pgrads = _port_grads(pmodel, pparams, pb)
    np.testing.assert_allclose(ploss, rloss, rtol=LOSS_RTOL)
    got = _named(pgrads)
    assert [n for n, _ in got] == [n for n, _ in want]
    top = max(float(np.abs(w).max()) for _, w in want)
    zero = _zero_leaves(name, pmodel.cfg)
    for (n, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, n
        if n in zero:
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= ZERO_GRAD * top, n
            continue
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL * float(np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_bfloat16_grads_match_reference(name):
    _, _, pmodel, pparams = _pair(name, "bfloat16")
    (_, pb), = _batches(pmodel.cfg, 1)
    rloss, want = _reference_grads(name, "bfloat16", None)
    _, want32 = _reference_grads(name, "float32", None)
    ploss, pgrads = _port_grads(pmodel, pparams, pb)
    np.testing.assert_allclose(ploss, rloss, rtol=1e-2)
    top = max(float(np.abs(w).max()) for _, w in want32)
    zero = _zero_leaves(name, pmodel.cfg)
    d = max(float(np.abs(w - w32).max()) / float(np.abs(w).max())
            for (n, w), (_, w32) in zip(want, want32) if n not in zero)
    for (n, g), (_, w) in zip(_named(pgrads), want):
        if n in zero:
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= ZERO_GRAD * top, n
            continue
        atol = max(BF16_ATOL, (2 if pmodel.cfg.moe and n in ROUTED else 1) * d)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * float(np.abs(w).max()), err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_three_compressed_train_steps_match_reference(name):
    _, _, pmodel, pparams = _pair(name, "float32")
    pgc = GradCompressConfig(eb_rel=1e-3)
    pstep = steps.make_train_step(pmodel, AdamWConfig(**OPT), pgc)
    popt = steps.init_opt_state(pparams, pgc)
    lr_sum = 0.0
    ref = _reference_run(name, "float32", None)[1]
    for (_, pb), (rm, rparams) in zip(_batches(pmodel.cfg, STEPS), ref, strict=True):
        pparams, popt, pm = pstep(pparams, popt, pb)
        assert sorted(pm) == sorted(rm)
        np.testing.assert_allclose(float(pm["loss"]), rm["loss"], rtol=LOSS_RTOL)
        assert float(pm["tokens"]) == rm["tokens"]
        np.testing.assert_allclose(float(pm["grad_norm"]), rm["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(float(pm["wire_bits_per_value"]), rm["wire_bits_per_value"],
                                   rtol=1e-3)
        lr_sum += rm["lr"]
        for (n, g), (_, w) in zip(_named(pparams), rparams, strict=True):
            err = np.abs(g - w)
            tol = PARAM_ATOL * float(np.abs(w).max()) + 2 * F32_RTOL * lr_sum
            allowed = max(FLIP_SHARE * err.size, ADAM_OUTLIERS)
            assert int((err > tol).sum()) <= allowed, (n, int((err > tol).sum()), allowed)
            assert float(err.max()) <= tol + 2 * lr_sum, (n, float(err.max()), lr_sum)
    assert int(popt["adam"]["step"]) == STEPS


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_grads_equal_without_remat(name):
    """Each scanned unit under `torch.utils.checkpoint` (cfg.remat, the
    train step's default) gives the loss and gradients of the plain
    forward bit for bit: no checkpointed unit writes into a tensor its
    recompute reads (training runs without a cache)."""
    _, _, pmodel, pparams = _pair(name, "float32")
    (_, pb), = _batches(pmodel.cfg, 1)
    assert pmodel.cfg.remat
    loss_r, grads_r = _port_grads(pmodel, pparams, pb)
    loss_p, grads_p = _port_grads(build_model(pmodel.cfg.scaled(remat=False), device="cpu"),
                                  pparams, pb)
    assert loss_r == loss_p
    for (n, a), (_, b) in zip(_named(grads_r), _named(grads_p), strict=True):
        np.testing.assert_array_equal(a, b, err_msg=n)
