"""Multi-pod dry run: every (arch x shape) cell traced on the production
meshes in one process, with its memory, cost, collectives and roofline.

Port of `repro.launch.dryrun`. Where the reference lowers and compiles a
cell with XLA on 256 or 512 emulated CPU devices, this module runs the
cell's step once, in ONE process, on a fake process group of 256 or 512
ranks (`torch.distributed`'s ``fake`` backend: collectives return at once)
and on fake tensors (`FakeTensorMode`: shapes, dtypes and devices, no
storage), and counts what rank 0's step does:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

(add ``--device cpu`` on a machine without a GPU: the fake tensors then
carry the CPU's device type instead of the card's).

The step is the code serving and training run, on params, Adam state,
batch and cache laid out as DTensors by the same `tree_shardings`,
`batch_shardings` and `cache_sharding`: train is `steps.make_train_step`
(`loss_and_grads` with the per-layer remat, then `adamw.update`), prefill
`steps.make_prefill_step`, decode one token through
`steps.make_decode_step` (the forward, then the greedy argmax).

What is counted (`StepCounter`, a dispatch mode below DTensor, so every
op and collective is seen on rank 0's local tensors):

* FLOPs: `torch.utils.flop_counter`'s formulas (matmuls, attention,
  convolutions) on each local op. `FlopCounterMode` itself would count a
  DTensor op at its global shape.
* bytes accessed: each op's input and output bytes (views, metadata ops
  and collectives move none; an indexed write into a tensor counts its
  source twice, read and written, not the whole destination). XLA counts
  the same per fused HLO op, so an elementwise chain it fuses counts once
  there and once an op here (PERF.md §3).
* collectives by kind: count and per-rank bytes of each result, as the
  reference's `hlo_collective_bytes` sums result shapes: the port's
  host-staged `dist.all_gather`, `reduce_scatter_tensor` and `all_reduce`
  (c10d ops) and DTensor's own functional collectives alike.
* memory: `argument_bytes` the local shard bytes of every input (exact),
  `output_bytes` those of every output, `alias_bytes` those of the inputs
  the step updates in place (the reference's donated ones), `temp_bytes`
  `MemTracker`'s peak less the arguments.

Every layer runs, so the reference's 1- and 2-unit extrapolation
(`corrected`) is a check here: for a uniform stack it equals the
full-depth count.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any

import torch

from ..configs import ARCHS, get_config
from ..core import pytree
from ..models import build_model
from ..models import nn
from ..models.config import ModelConfig
from ..optim import adamw
from ..runtime import dist, sharding, steps
from . import shapes as shp
from .mesh import make_production_mesh

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet figures (roofline)
PEAK_FLOPS = 989.4e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12       # HBM3 B/s
ICI_BW = 450e9         # NVLink 4 B/s one way per GPU (one link constant, as the reference)

VARIANTS = ("baseline", "tp_weights", "seqkv", "kvq8", "bf16params", "combo", "moegroups",
            "ds_best")


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in (mesh.mesh_dim_names or ()))


def batch_shardings(batch_abs: Any, mesh, global_batch: int) -> Any:
    """A `NamedSharding` per leaf of `batch_abs` (nested dicts of anything
    with a `.shape`): the leading (batch) dim over the data dims ('pod',
    'data') when `global_batch` divides by their size, everything else
    replicated."""
    dp = _dp_axes(mesh)
    sizes = sharding.mesh_shape(mesh)
    dp_n = math.prod(sizes[a] for a in dp)
    first = (dp[0] if len(dp) == 1 else dp) if global_batch % dp_n == 0 else None

    def _s(leaf) -> sharding.NamedSharding:
        spec = (first,) + (None,) * (len(leaf.shape) - 1)
        return sharding.NamedSharding(mesh, sharding.spec_to_placements(mesh, spec))

    return nn.tree_map(_s, batch_abs)


# ---------------------------------------------------------------------------
# per-family layer-unit scaling (the reference's scan-body extrapolation)
# ---------------------------------------------------------------------------


def with_units(cfg: ModelConfig, n: int) -> ModelConfig:
    """Reduced-depth variant of `n` layer units (the reference unrolls them
    so its cost analysis counts every body; here every layer runs)."""
    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=n, n_enc_layers=n, unroll_layers=True)
    if cfg.xlstm is not None:
        per = cfg.xlstm.m_per_group + cfg.xlstm.s_per_group
        return dataclasses.replace(cfg, n_layers=n * per, unroll_layers=True)
    if cfg.hybrid is not None:
        return dataclasses.replace(cfg, n_layers=n * cfg.hybrid.every, unroll_layers=True)
    nd = cfg.moe.n_dense_layers if cfg.moe else 0
    return dataclasses.replace(cfg, n_layers=nd + n, unroll_layers=True)


def full_units(cfg: ModelConfig) -> float:
    if cfg.encdec:
        return cfg.n_layers
    if cfg.xlstm is not None:
        return cfg.n_layers / (cfg.xlstm.m_per_group + cfg.xlstm.s_per_group)
    if cfg.hybrid is not None:
        return cfg.n_layers / cfg.hybrid.every  # tail folded in (~2% error)
    nd = cfg.moe.n_dense_layers if cfg.moe else 0
    return cfg.n_layers - nd


# ---------------------------------------------------------------------------
# analytic model FLOPs (roofline reference)
# ---------------------------------------------------------------------------


def count_params(model) -> tuple[float, float]:
    """(total, active) parameter counts; MoE expert tensors scaled by
    top_k/n_experts for the active count."""
    cfg = model.cfg
    leaves, _ = pytree.flatten_with_path(nn.abstract_tree(model.desc()))
    total = active = 0.0
    for path, leaf in leaves:
        name = pytree.leaf_name(path)
        n = float(math.prod(leaf.shape))
        total += n
        if cfg.moe and ("/w_gate" in name or "/w_up" in name or "/w_down" in name) \
                and len(leaf.shape) >= 4:
            active += n * (cfg.moe.top_k / cfg.moe.n_experts)
        else:
            active += n
    return total, active


def model_flops(model, kind: str, b: int, seq: int) -> float:
    total, active = count_params(model)
    if kind == "train":
        return 6.0 * active * b * seq
    if kind == "prefill":
        return 2.0 * active * b * seq
    return 2.0 * active * b  # decode: one token


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

#: collective op name (the packet's last part) -> the reference's kind
_COLLECTIVES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast", "gather_": "gather", "scatter_": "scatter",
}
#: ops that write part of their first argument: their source is read and
#: written, the rest of the destination untouched
_INDEXED_WRITES = {"index_copy_", "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
                   "index_add_", "masked_scatter_", "index_fill_", "slice_scatter"}
#: ops that move no bytes
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "sym_size", "sym_stride", "sym_numel", "device",
         "is_same_size", "_local_scalar_dense", "set_", "resize_", "record_stream"}


def _tensors(x) -> list[torch.Tensor]:
    out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            out.extend(_tensors(y))
    elif isinstance(x, dict):
        for y in x.values():
            out.extend(_tensors(y))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def local_bytes(tree: Any) -> int:
    """The bytes of this rank's shards of every tensor leaf of `tree`."""
    return sum(_nbytes([dist.local(t)]) for t in pytree.leaves(tree) if isinstance(t, torch.Tensor))


#: DTensor's sharding propagation runs each op once more on fake tensors of
#: the global shape, in the active fake mode: no work of the step's
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"})


def _propagating() -> bool:
    """Whether the caller runs inside DTensor's sharding propagation."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


def _mem_tracker():
    """A `MemTracker` that ignores DTensor's sharding propagation (which
    it would otherwise count, and keep, under an outer `FakeTensorMode`)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _Tracker()


class StepCounter:
    """FLOPs, bytes accessed and collectives of everything run while it is
    entered, on this rank's local tensors (a `TorchDispatchMode` that lets
    DTensor run first, as `CommDebugMode` does, and then sees its local ops
    and collectives; DTensor's sharding propagation is skipped)."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, float] = {}
        self.collective_counts: dict[str, int] = {}

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not _propagating():
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self._mode = _Mode()

    def _count(self, func, args, kwargs, out, registry) -> None:
        packet = getattr(func, "_overloadpacket", None)
        ns, _, name = str(packet).rpartition(".")
        kind = _COLLECTIVES.get(name) if ns in ("c10d", "_c10d_functional") else None
        if kind is not None:
            # the result's bytes: a functional op's output, a c10d op's first
            # (output) argument
            res = _tensors(args[:1]) if ns == "c10d" else _tensors(out)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + float(_nbytes(res))
            self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
            return
        if packet in registry:
            self.flops += int(registry[packet](*args, **kwargs, out_val=out))
        if ns != "aten" or name in _FREE or getattr(func, "is_view", False):
            return
        if name in _INDEXED_WRITES:
            self.bytes += 2 * _nbytes(_tensors(args[1:]) + _tensors(kwargs))
            return
        self.bytes += _nbytes(_tensors(args) + _tensors(kwargs)) + _nbytes(_tensors(out))

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


@dataclasses.dataclass
class MemoryAnalysis:
    """The four sizes of XLA's `memory_analysis()`, for rank 0."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


@dataclasses.dataclass
class CountedStep:
    """What `lower_cell` returns in place of the reference's `compiled`:
    the counts of one traced step, and the step itself (`run`), callable
    on real tensors in the same layouts (`inputs` gives each input leaf's
    spec and sharding)."""

    step: Any
    mesh: Any
    rules: dict
    inputs: tuple        # per step argument: a tree of (TensorSpec, NamedSharding)
    donated: tuple       # the argument positions updated in place
    flops: int
    bytes_accessed: int
    collectives: dict
    collective_counts: dict
    memory: MemoryAnalysis
    peak_bytes: int
    seconds: float

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed)}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def run(self, *args):
        """The step on real inputs laid out as `inputs` says, under the
        cell's mesh and rules."""
        with sharding.activate(self.mesh, self.rules):
            return self.step(*args)


def _pair(specs: Any, shards: Any) -> Any:
    return nn.tree_map(lambda s, sh: (s, sh), specs, shards)


def materialize(tree: Any, make, device=None) -> Any:
    """A tree of (TensorSpec, NamedSharding) pairs as DTensors whose local
    shards are `make(local_shape, dtype, device)`; a pair whose sharding is
    None as the plain tensor `make(shape, dtype, device)` (Adam's step
    count, the same on every rank)."""
    def one(pair):
        spec, sh = pair
        if sh is None:
            return make(spec.shape, spec.dtype, device)
        start, stop = sharding.local_box(sh, spec.shape)
        local = make(tuple(b - a for a, b in zip(start, stop)), spec.dtype,
                     sharding.mesh_device(sh.mesh))
        return sharding.from_local(local, sh, spec.shape)

    return nn.tree_map(one, tree)


def draw_inputs(compiled: CountedStep, info: dict, generator: torch.Generator) -> tuple:
    """Real inputs for a counted cell, laid out as `compiled.inputs` says,
    each rank drawing its own shards from `generator` (on the mesh's
    device): floats N(0, 0.02^2), int8 codes uniform in [-127, 127], token
    ids and labels uniform in the vocab, and the 0-d counters (the cache's
    clock at its last row, cache_len - 1, so the step attends the whole
    cache; Adam's step at 0)."""
    vocab, last = info["cfg"].vocab, info["spec"].get("cache_len", 1) - 1

    def make(shape, dtype, device):
        if dtype.is_floating_point:
            x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            return x.mul_(0.02).to(dtype)
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=generator, dtype=dtype, device=device)
        if not shape:
            return torch.full((), last if info["spec"]["kind"] != "train" else 0, dtype=dtype,
                              device=device)
        return torch.randint(0, vocab, shape, generator=generator, dtype=dtype, device=device)

    dev = generator.device
    return tuple(materialize(a, make, dev) for a in compiled.inputs)


def calibrate(compiled: CountedStep, info: dict, generator: torch.Generator,
              reps: int = 5) -> dict:
    """The counted step run for real on the card, on inputs drawn from
    `generator` (`draw_inputs`; a one-rank mesh of the card, whose process
    group is up): its `FlopCounterMode` count, its inputs' bytes, the
    card's peak of one step (`max_memory_allocated` less what was
    allocated before it but the inputs: cuBLAS's workspace, taken by a
    first step) and the step's ms (CUDA events, each of `reps` steps),
    beside the dry run's counts."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = generator.device
    args = draw_inputs(compiled, info, generator)
    arg_bytes = sum(local_bytes(a) for a in args)
    compiled.run(*args)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev) - arg_bytes
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as flops:
        compiled.run(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        compiled.run(*args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return dict(flops_dry=compiled.flops, flops_card=int(flops.get_total_flops()),
                argument_bytes_dry=compiled.memory.argument_size_in_bytes,
                argument_bytes_card=arg_bytes, peak_bytes_dry=compiled.peak_bytes,
                peak_bytes_card=peak, peak_rel=abs(compiled.peak_bytes - peak) / peak,
                step_ms=ms)


def lower_cell(arch: str, shape_name: str, mesh, *, units: int | None = None,
               opt_cfg: adamw.AdamWConfig | None = None, variant: str = "baseline"):
    """Trace one cell's step on fake tensors laid out on `mesh` (optionally
    at a reduced layer-unit count) and count it. variant: 'baseline' |
    'tp_weights' (no FSDP over weight embed dims) | 'seqkv' (a
    sequence-split KV cache where heads cannot split) | 'kvq8' (the int8
    KV cache) | 'bf16params' | 'combo' (seqkv + kvq8) | 'moegroups' (32
    MoE dispatch groups) | 'ds_best' (bf16params + moegroups).
    Returns (CountedStep, info dict)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg0 = shp.shape_config(get_config(arch), shape_name)
    cfg = with_units(cfg0, units) if units is not None else cfg0
    if variant in ("kvq8", "combo"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if variant in ("moegroups", "ds_best") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=32))
    dev = sharding.mesh_device(mesh)
    model = build_model(cfg, device=dev)
    spec = shp.input_specs(cfg, shape_name)
    kind = spec["kind"]
    if kind == "train":
        rules = sharding.TRAIN_RULES_TP if variant == "tp_weights" else sharding.TRAIN_RULES
    else:
        rules = sharding.SERVE_RULES
    desc = model.desc()
    params_abs = nn.tree_map(lambda p: nn.TensorSpec(p.shape, p.dtype), desc)
    if variant in ("bf16params", "ds_best"):
        # bf16 parameter storage (float32 Adam moments remain the master copy)
        params_abs = nn.tree_map(lambda s: nn.TensorSpec(s.shape, torch.bfloat16)
                                 if s.dtype == torch.float32 else s, params_abs)
    pshard = sharding.tree_shardings(nn.axes_tree(desc), rules, mesh, abstract=params_abs)
    b = spec["global_batch"]
    bshard = batch_shardings(spec["batch"], mesh, b)
    params_in = _pair(params_abs, pshard)
    if kind == "train":
        f32 = nn.tree_map(lambda s: nn.TensorSpec(s.shape, torch.float32), params_abs)
        opt_in = {"adam": {"m": _pair(f32, pshard), "v": _pair(f32, pshard),
                           "step": (nn.TensorSpec((), torch.int32), None)}}
        inputs = (params_in, opt_in, _pair(spec["batch"], bshard))
        step = steps.make_train_step(model, opt_cfg or adamw.AdamWConfig())
        donated = (0, 1)
    else:
        cache_abs = model.cache_desc(b, spec["cache_len"])
        cshard = sharding.cache_sharding(cache_abs, mesh, b, {cfg.n_kv_heads, cfg.n_heads},
                                         seq_shard=variant in ("seqkv", "combo"))
        cache_in = _pair(cache_abs, cshard)
        if kind == "prefill":
            inputs = (params_in, _pair(spec["batch"], bshard), cache_in)
            step = steps.make_prefill_step(model)
        else:
            tok = spec["batch"]["tokens"]
            inputs = (params_in, (tok, batch_shardings({"t": tok}, mesh, b)["t"]), cache_in)
            step = steps.make_decode_step(model)
        donated = (2,)

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(materialize(a, lambda shape, dtype, d: torch.zeros(shape, dtype=dtype,
                                                                        device=d), dev)
                     for a in inputs)
        arg_bytes = sum(local_bytes(a) for a in args)
        alias_bytes = sum(local_bytes(args[i]) for i in donated)
        tracker = _mem_tracker()
        tracker.track_external(*[dist.local(t) for a in args for t in pytree.leaves(a)])
        with sharding.activate(mesh, rules), tracker, StepCounter() as counter:
            out = step(*args)
        out_bytes = local_bytes(out)
        peak = sum(int(v["Total"]) for v in tracker.get_tracker_snapshot("peak").values())
    seconds = time.perf_counter() - t0
    compiled = CountedStep(
        step=step, mesh=mesh, rules=rules, inputs=inputs, donated=donated,
        flops=counter.flops, bytes_accessed=counter.bytes, collectives=dict(counter.collectives),
        collective_counts=dict(counter.collective_counts),
        memory=MemoryAnalysis(arg_bytes, out_bytes, alias_bytes, max(peak - arg_bytes, 0)),
        peak_bytes=peak, seconds=seconds)
    return compiled, {"cfg": cfg, "model": model, "spec": spec}


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world_size: int):
    """A process group of `world_size` fake ranks in this process, as rank
    0 (`torch.distributed`'s ``fake`` backend: every collective returns at
    once), torn down on exit. Nothing else may be joined meanwhile."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if torch.distributed.is_initialized():
        raise RuntimeError("a process group is up already: the dry run needs a fresh process")
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def analyze_cell(arch: str, shape_name: str, mesh_name: str, extrapolate: bool = True,
                 variant: str = "baseline", *, mesh=None, device: str = "cuda") -> dict:
    """One cell's record, with the reference's keys. `mesh` defaults to
    the production mesh of `mesh_name` over the current (fake) group."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device=device)
    chips = int(mesh.mesh.numel())
    cfg0 = shp.shape_config(get_config(arch), shape_name)
    ok, why = shp.applicable(cfg0, shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
                 "variant": variant}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    try:
        t0 = time.time()
        compiled, info = lower_cell(arch, shape_name, mesh, variant=variant)
        rec["compile_seconds"] = round(time.time() - t0, 1)
        ca = compiled.cost_analysis()
        mem = compiled.memory_analysis()
        rec["cost_raw"] = {"flops": float(ca["flops"]), "bytes": float(ca["bytes accessed"])}
        rec["memory"] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "alias_bytes": int(mem.alias_size_in_bytes),
        }
        coll = dict(compiled.collectives)
        rec["collectives_raw"] = coll
        rec["collective_counts"] = dict(compiled.collective_counts)
        spec = info["spec"]
        if extrapolate:
            vals = {}
            for u in (1, 2):
                c_u, _ = lower_cell(arch, shape_name, mesh, units=u, variant=variant)
                vals[u] = {"flops": float(c_u.flops), "bytes": float(c_u.bytes_accessed),
                           "coll": sum(c_u.collectives.values())}
            units = full_units(info["cfg"])
            corr = {}
            for k in ("flops", "bytes", "coll"):
                b_ = vals[2][k] - vals[1][k]
                a_ = vals[1][k] - b_
                corr[k] = a_ + b_ * units
            rec["corrected"] = {"flops": corr["flops"], "bytes": corr["bytes"],
                                "collective_bytes": corr["coll"], "units": units}
        mf = model_flops(info["model"], spec["kind"], spec["global_batch"], spec["seq"])
        rec["model_flops"] = mf
        flops = rec.get("corrected", rec["cost_raw"])["flops"]
        bts = rec.get("corrected", rec["cost_raw"])["bytes"]
        cb = rec.get("corrected", {}).get("collective_bytes", sum(coll.values()))
        # the counts are rank 0's, as XLA's cost analysis is per device
        rec["roofline"] = {
            "t_compute_s": flops / PEAK_FLOPS,
            "t_memory_s": bts / HBM_BW,
            "t_collective_s": cb / ICI_BW,
            "useful_flops_ratio": mf / chips / max(flops, 1.0),
        }
        terms = rec["roofline"]
        rec["roofline"]["dominant"] = max(("t_compute_s", "t_memory_s", "t_collective_s"),
                                          key=lambda k: terms[k])
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="the device type the fake tensors carry (cuda, or cpu on a machine "
                         "without a GPU); nothing is allocated on it")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes_ = list(shp.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    statuses: dict[str, int] = {}
    for mesh_name in meshes:
        with fake_group(512 if mesh_name == "multi" else 256):
            mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device=args.device)
            for arch in archs:
                for shape_name in shapes_:
                    suffix = "" if args.variant == "baseline" else f"__{args.variant}"
                    path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
                    if os.path.exists(path):
                        print(f"[cached] {path}")
                        with open(path) as f:
                            status = json.load(f)["status"]
                        statuses[status] = statuses.get(status, 0) + 1
                        continue
                    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ...", flush=True)
                    rec = analyze_cell(arch, shape_name, mesh_name,
                                       extrapolate=not args.no_extrapolate,
                                       variant=args.variant, mesh=mesh)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    statuses[rec["status"]] = statuses.get(rec["status"], 0) + 1
                    extra = rec.get("reason", rec.get("error", ""))
                    rl = rec.get("roofline", {})
                    print(f"  -> {rec['status']} {extra} compile={rec.get('compile_seconds', '-')}s "
                          f"dom={rl.get('dominant', '-')}", flush=True)
    print(f"[dryrun] variant {args.variant}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(statuses.items())), flush=True)


__all__ = ["CountedStep", "HBM_BW", "ICI_BW", "MemoryAnalysis", "PEAK_FLOPS", "StepCounter",
           "VARIANTS", "analyze_cell", "batch_shardings", "calibrate", "count_params", "draw_inputs",
           "fake_group",
           "full_units", "local_bytes", "lower_cell", "main", "materialize", "model_flops",
           "with_units"]


if __name__ == "__main__":
    main()
