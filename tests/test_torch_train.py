"""Training on the port (`repro_torch.runtime.steps.make_train_step`,
`repro_torch.launch.train`) against the live reference on the CPU, at the
reference's own test sizes (`tests/test_integration.py`): the
`reduced_for_smoke` configs with 2 layers, `AdamWConfig(lr=1e-3,
total_steps=100, warmup_steps=5)`, sequences of 64 tokens, batches of 4,
the reference's weights carried across (`nn.params_from_reference`).

Tolerances, each with its reason:

* Gradients at float32: each leaf within atol 1e-5 * max|g_ref| plus
  rtol 1e-4 (the same float32 math; matmul sums in other orders, XLA's
  `rsqrt`/`cos`/`sin` a few ulps from torch's). At bfloat16: atol
  2e-2 * max|g_ref| (every activation rounds to bfloat16, and the two
  packages' matmuls round their float32 sums at different points).
* Five chained train steps at float32: losses within a relative 1e-5, and
  params within 1e-5 * max|p| per leaf but for a few values. Adam's step
  is normalized, m / (sqrt(v) + eps), so a gradient near eps (1e-8) takes
  a step of order lr, and there the two packages' gradients, which differ
  by ulps, give steps a fraction of lr apart: at most `ADAM_OUTLIERS`
  values a leaf may be off, each by at most 2 * sum of the steps' lr
  (the most two opposite Adam steps can part). With gradient
  compression a code k = round(g / delta) also flips by one where the two
  gradients straddle a rounding midpoint; the dequantized gradient then
  moves by delta and that parameter's step by up to about lr, and the
  flips feed later steps. Then at most `FLIP_SHARE` of a leaf's values may
  be off, by the same 2 * sum of lr.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as RConfig
from repro.checkpoint import CheckpointManager as RManager
from repro.configs import get_config as r_get_config
from repro.core import Policy as RPolicy
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import build_model as r_build_model
from repro.models import nn as rnn
from repro.models import reduced_for_smoke as r_reduced
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import GradCompressConfig as RGradCompressConfig
from repro.runtime import steps as rsteps
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import Policy, PolicySet, pytree
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.launch import train
from repro_torch.models import build_model, reduced_for_smoke
from repro_torch.models import nn as pnn
from repro_torch.optim import AdamWConfig, GradCompressConfig
from repro_torch.runtime import steps

DENSE = ["smollm-360m", "starcoder2-7b", "minitron-4b"]  # swiglu, gelu, relu2
OPT = dict(lr=1e-3, total_steps=100, warmup_steps=5)
SEQ, BATCH = 64, 4
F32_ATOL, F32_RTOL = 1e-5, 1e-4
BF16_ATOL = 2e-2
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
#: values a leaf may have off 1e-5 * max|p| after the chained steps: without
#: gradient compression (Adam near eps), and the share with it (flipped codes)
ADAM_OUTLIERS = 8
FLIP_SHARE = 5e-3
SMOKE = ["--device", "cpu", "--smoke", "--n-layers", "2", "--seq", str(SEQ),
         "--batch", str(BATCH), "--lr", "1e-3", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tensors here are small, and test
    workers running in parallel would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, dtype="float32", **over):
    """(reference model, its params, port model, port params): the reduced
    2-layer config, the port's weights copied from the reference's."""
    rmodel = r_build_model(r_reduced(r_get_config(name)).scaled(n_layers=2, dtype=dtype, **over))
    rparams = rnn.init_tree(rmodel.desc(), jax.random.key(0))
    pmodel = build_model(
        reduced_for_smoke(get_config(name)).scaled(n_layers=2, dtype=dtype, **over), device="cpu")
    return rmodel, rparams, pmodel, _from_ref(rparams)


def _from_ref(tree):
    return pnn.params_from_reference(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _batches(vocab, n, start=0):
    """(reference batch, port batch) pairs of the same numpy draws."""
    rcfg = RDataConfig(vocab=vocab, seq_len=SEQ, global_batch=BATCH)
    pcfg = DataConfig(vocab=vocab, seq_len=SEQ, global_batch=BATCH)
    out = []
    for s in range(start, start + n):
        r, p = r_synthetic_batch(rcfg, s), synthetic_batch(pcfg, s)
        assert all(np.array_equal(r[k], p[k]) for k in r)
        out.append(({k: jnp.asarray(v) for k, v in r.items()},
                    {k: torch.from_numpy(v) for k, v in p.items()}))
    return out


def _named(tree):
    return [(pytree.leaf_name(path), np.asarray(leaf))
            for path, leaf in pytree.flatten_with_path(tree)[0]]


def _port_grads(model, params, batch):
    leaves, treedef = pytree.flatten_with_path(params)
    tracked = [p.detach().requires_grad_(True) for _, p in leaves]
    loss, _ = model.loss(pytree.unflatten(treedef, tracked), batch)
    return loss, pytree.unflatten(treedef, list(torch.autograd.grad(loss, tracked)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_grads_match_reference(name, dtype):
    rmodel, rparams, pmodel, pparams = _pair(name, dtype)
    (rb, pb), = _batches(pmodel.cfg.vocab, 1)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(rparams, rb)
    ploss, pgrads = _port_grads(pmodel, pparams, pb)
    np.testing.assert_allclose(float(ploss.detach()), float(rloss), rtol=LOSS_RTOL if dtype == "float32" else 1e-2)
    got, want = _named(pgrads), _named(rgrads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, n
        scale = float(np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL * scale, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=BF16_ATOL * scale, err_msg=n)


@pytest.mark.parametrize("name", ["smollm-360m", "minitron-4b"])
def test_remat_grads_equal_without_remat(name, monkeypatch):
    """Per-layer checkpointing (non-reentrant, one call a layer) gives the
    gradients of the plain forward bit for bit; a forward without autograd
    takes no checkpoint."""
    import repro_torch.models.model as pmodel_mod

    _, _, pmodel, pparams = _pair(name, "float32")
    plain = build_model(pmodel.cfg.scaled(remat=False), device="cpu")
    assert pmodel.cfg.remat
    (_, pb), = _batches(pmodel.cfg.vocab, 1)
    calls = []
    real = pmodel_mod.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(pmodel_mod, "checkpoint", counted)
    loss_r, grads_r = _port_grads(pmodel, pparams, pb)
    assert calls == [False] * pmodel.cfg.n_layers
    loss_p, grads_p = _port_grads(plain, pparams, pb)
    assert torch.equal(loss_r, loss_p)
    for (n, a), (_, b) in zip(_named(grads_r), _named(grads_p)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    calls.clear()
    with torch.no_grad():
        pmodel.loss(pparams, pb)
    assert calls == []


def _check_params(got_tree, want_tree, gc: bool, lr_sum: float):
    for (n, g), (_, w) in zip(_named(got_tree), _named(want_tree)):
        err = np.abs(g - w)
        tol = PARAM_ATOL * float(np.abs(w).max())
        allowed = FLIP_SHARE * err.size if gc else ADAM_OUTLIERS
        assert int((err > tol).sum()) <= allowed, (n, int((err > tol).sum()), allowed)
        assert float(err.max()) <= tol + 2 * lr_sum, (n, float(err.max()), lr_sum)


@pytest.mark.parametrize("name,gc", [("smollm-360m", False), ("starcoder2-7b", False),
                                     ("minitron-4b", False), ("smollm-360m", True),
                                     ("minitron-4b", True)])
def test_five_train_steps_match_reference(name, gc):
    rmodel, rparams, pmodel, pparams = _pair(name, "float32")
    rgc, pgc = (RGradCompressConfig(eb_rel=1e-3), GradCompressConfig(eb_rel=1e-3)) if gc else (None, None)
    rstep = jax.jit(rsteps.make_train_step(rmodel, RAdamWConfig(**OPT), rgc))
    pstep = steps.make_train_step(pmodel, AdamWConfig(**OPT), pgc)
    ropt, popt = rsteps.init_opt_state(rparams, rgc), steps.init_opt_state(pparams, pgc)
    assert sorted(popt) == sorted(ropt)
    lr_sum = 0.0
    for rb, pb in _batches(pmodel.cfg.vocab, 5):
        rparams, ropt, rm = rstep(rparams, ropt, rb)
        pparams, popt, pm = pstep(pparams, popt, pb)
        assert sorted(pm) == sorted(rm)
        assert all(v.ndim == 0 for v in pm.values())
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
        assert float(pm["tokens"]) == float(rm["tokens"])
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-6)
        if gc:
            np.testing.assert_allclose(float(pm["wire_bits_per_value"]),
                                       float(rm["wire_bits_per_value"]), rtol=1e-3)
        lr_sum += float(rm["lr"])
        _check_params(pparams, rparams, gc, lr_sum)
    assert int(popt["adam"]["step"]) == 5 and popt["adam"]["step"].dtype == torch.int32


def test_train_step_updates_in_place():
    _, _, pmodel, pparams = _pair("smollm-360m", "float32")
    gc = GradCompressConfig(eb_rel=1e-3)
    opt = steps.init_opt_state(pparams, gc)
    wq, m, r = pparams["blocks"]["attn"]["wq"], opt["adam"]["m"]["embed"], opt["gc"]["residual"]["lm_head"]
    before = wq.clone()
    (_, pb), = _batches(pmodel.cfg.vocab, 1)
    new_p, new_opt, metrics = steps.make_train_step(pmodel, AdamWConfig(**OPT), gc)(pparams, opt, pb)
    assert new_p["blocks"]["attn"]["wq"] is wq and not torch.equal(wq, before)
    assert new_opt["adam"]["m"]["embed"] is m and new_opt["gc"]["residual"]["lm_head"] is r
    assert bool(r.any()) and not wq.requires_grad
    assert sorted(metrics) == ["grad_norm", "loss", "lr", "tokens", "wire_bits_per_value"]


def test_opt_state_from_reference():
    """The reference's optimizer tree crosses with its int32 step."""
    _, rparams, _, _ = _pair("smollm-360m", "float32")
    ropt = rsteps.init_opt_state(rparams, RGradCompressConfig())
    ropt["adam"]["step"] = jnp.asarray(7, jnp.int32)
    popt = _from_ref(ropt)
    assert sorted(popt) == ["adam", "gc"] and sorted(popt["adam"]) == ["m", "step", "v"]
    assert popt["adam"]["step"].dtype == torch.int32 and popt["adam"]["step"].ndim == 0
    assert int(popt["adam"]["step"]) == 7
    for (n, a), (_, b) in zip(_named(popt), _named(ropt)):
        assert a.dtype == b.dtype and a.shape == b.shape, n


# --- the launcher ----------------------------------------------------------


def test_launcher_reduces_loss():
    out = train.main(SMOKE + ["--steps", "25"])
    losses = out["losses"]
    assert len(losses) == 25 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 0.3, losses
    assert out["params"]["embed"].device.type == "cpu"


def test_launcher_grad_compression_tracks_baseline():
    base = train.main(SMOKE + ["--steps", "20"])["losses"]
    comp = train.main(SMOKE + ["--steps", "20", "--compress-grads"])["losses"]
    assert abs(np.mean(comp[-5:]) - np.mean(base[-5:])) < 0.25, (base[-5:], comp[-5:])


def test_launcher_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = train.main(SMOKE + ["--steps", "5", "--ckpt-dir", ckpt, "--ckpt-every", "5"])
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_000000005"]
    restored = {}
    real = CheckpointManager.restore_tree

    def kept(self, template, step=None, shardings=None):
        out = real(self, template, step, shardings)
        restored["step"], restored["tree"] = out[0], pytree.unflatten(
            pytree.flatten_with_path(out[1])[1],
            [t.clone() for _, t in pytree.flatten_with_path(out[1])[0]])
        return out

    monkeypatch.setattr(CheckpointManager, "restore_tree", kept)
    second = train.main(SMOKE + ["--steps", "8", "--ckpt-dir", ckpt, "--ckpt-every", "5", "--resume"])
    assert "[resume] restored step 5" in capsys.readouterr().out
    assert restored["step"] == 5 and len(second["losses"]) == 3
    assert all(np.isfinite(second["losses"]))
    for (n, a), (_, b) in zip(_named(restored["tree"]["params"]), _named(first["params"])):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert int(restored["tree"]["opt"]["step"]) == 5
    assert restored["tree"]["opt"]["step"].dtype == torch.int32
    _, flat = CheckpointManager(CheckpointConfig(ckpt), device="cpu").restore(8)
    assert int(flat["opt/step"]) == 8
    for (n, a) in _named({"params": second["params"]}):
        np.testing.assert_array_equal(flat[n].numpy(), a, err_msg=n)


def test_launcher_lossy_checkpoint_with_opt_policy(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = train.main(SMOKE + ["--steps", "4", "--ckpt-dir", ckpt, "--ckpt-every", "2",
                                "--compress-ckpt", "--ckpt-opt-ratio", "8"])
    mgr = CheckpointManager(CheckpointConfig(ckpt), device="cpu")
    with open(os.path.join(ckpt, "step_000000004", "manifest.json")) as f:
        rows = {r["name"]: r for r in json.load(f)["fields"]}
    for name, row in rows.items():
        size = int(np.prod(row["shape"] or [1]))
        if name.startswith("opt/") and row["dtype"] == "float32" and size >= 64:
            assert row["policy"]["mode"] == "fixed_ratio", name
        elif name.startswith("params/") and size >= 64:
            assert row["policy"]["mode"] == "fixed_accuracy" and row["codec"] != "none", name
    assert rows["opt/step"]["codec"] == "none"
    _, flat = mgr.restore(4)
    for n, want in _named({"params": first["params"]}):
        if want.size >= 64:
            vr = float(want.max() - want.min())
            assert float(np.abs(flat[n].numpy() - want).max()) <= 1e-4 * vr * (1 + 1e-5), n
    # the first resumed step's loss is finite; the steps after it may not be:
    # a lossy v can decode below zero (ROADMAP.md §C), as in the reference
    again = train.main(SMOKE + ["--steps", "6", "--ckpt-dir", ckpt, "--resume",
                                "--compress-ckpt", "--ckpt-opt-ratio", "8"])
    assert len(again["losses"]) == 2 and np.isfinite(again["losses"][0])


def test_launcher_flags_match_reference():
    import argparse

    from repro.launch import train as rtrain

    seen = {}

    def grab(self, args=None, namespace=None):
        seen["dests"] = sorted(a.dest for a in self._actions if a.dest != "help")
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            rtrain.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    port = sorted(a for a in vars(train.parse_args([])) if a != "device")
    assert port == seen["dests"]


# --- checkpoints of the train tree ----------------------------------------


def test_async_save_of_the_train_tree_while_training(tmp_path):
    """`async_save` of {"params", "opt"} while the next steps update the
    params in place: the restore is the tree at the call, bit for bit
    (raw), and within each leaf's bound under a PolicySet with opt/*."""
    _, _, pmodel, pparams = _pair("smollm-360m", "float32")
    pstep = steps.make_train_step(pmodel, AdamWConfig(**OPT))
    opt = steps.init_opt_state(pparams)
    batches = _batches(pmodel.cfg.vocab, 4)
    pparams, opt, _ = pstep(pparams, opt, batches[0][1])
    pset = PolicySet(default=Policy.fixed_accuracy(eb_rel=1e-4),
                     rules=[("opt/*", Policy.fixed_ratio(8.0))])
    for sub, cfg in (("raw", CheckpointConfig(str(tmp_path / "raw"), compress=False)),
                     ("lossy", CheckpointConfig(str(tmp_path / "lossy"), policy=pset))):
        mgr = CheckpointManager(cfg, device="cpu")
        tree = {"params": pparams, "opt": opt["adam"]}
        want = [(n, a.copy()) for n, a in _named(tree)]
        mgr.async_save(1, tree)
        for _, pb in batches[1:3]:
            pparams, opt, _ = pstep(pparams, opt, pb)
        mgr.wait()
        now = _named({"params": pparams, "opt": opt["adam"]})
        assert any(not np.array_equal(a, w) for (_, a), (_, w) in zip(now, want))
        step, got = mgr.restore_tree({"params": pparams, "opt": opt["adam"]})
        assert step == 1
        for (n, g), (_, w) in zip(_named(got), want):
            if sub == "raw" or w.size < 64 or w.dtype != np.float32:
                np.testing.assert_array_equal(g, w, err_msg=n)
            elif n.startswith("params/"):
                vr = float(w.max() - w.min())
                assert float(np.abs(g - w).max()) <= 1e-4 * vr * (1 + 1e-5), n
        assert int(got["opt"]["step"]) == int(dict(want)["opt/step"])


def test_cross_package_resume(tmp_path):
    """The reference trains 3 steps and saves {"params", "opt"} with its
    CheckpointManager; the port restores that and takes step 4, which must
    match the reference's own step 4."""
    rmodel, rparams, pmodel, pparams = _pair("smollm-360m", "float32")
    rstep = jax.jit(rsteps.make_train_step(rmodel, RAdamWConfig(**OPT)))
    ropt = rsteps.init_opt_state(rparams)
    batches = _batches(pmodel.cfg.vocab, 4)
    for rb, _ in batches[:3]:
        rparams, ropt, _ = rstep(rparams, ropt, rb)
    ckpt = str(tmp_path / "ckpt")
    RManager(RConfig(ckpt, policy=RPolicy.fixed_accuracy(eb_rel=1e-4), compress=False)).save(
        3, {"params": rparams, "opt": ropt["adam"]})
    popt = steps.init_opt_state(pparams)
    step, restored = CheckpointManager(CheckpointConfig(ckpt), device="cpu").restore_tree(
        {"params": pparams, "opt": popt["adam"]})
    assert step == 3 and restored["opt"]["step"].dtype == torch.int32
    for (n, a), (_, b) in zip(_named(restored), _named({"params": rparams, "opt": ropt["adam"]})):
        np.testing.assert_array_equal(a, b, err_msg=n)
    rparams, ropt, rm = rstep(rparams, ropt, batches[3][0])
    pparams, popt, pm = steps.make_train_step(pmodel, AdamWConfig(**OPT))(
        restored["params"], {"adam": restored["opt"]}, batches[3][1])
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    _check_params(pparams, rparams, False, float(rm["lr"]))
    assert int(popt["adam"]["step"]) == 4


def test_train_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
