"""The port's dry-run launcher (`repro_torch.launch.dryrun`) against the
reference's `repro.launch.dryrun`.

Exact: `with_units` and `full_units` for every arch, field by field, and
`count_params` and `model_flops` for every arch x shape at full width.

Lowered: one one-process job (`repro_torch.launch.mhrun`, rank code
`tests/torch_shard_worker.py::scenario_dryrun`; the fake process group is
global to its process) lowers five cells at full width and one layer unit
(`lower_cell(units=1)`) on fake tensors over a fake group, while this
process lowers the same cells with the reference's `lower_cell` on an
`AxisType.Auto` mesh of the same shape over the emulated devices:
smollm-360m train_4k, decode_32k seqkv and train_4k on (2, 2, 2),
phi4-mini-3.8b decode_32k kvq8 and deepseek-v2-236b decode_32k on (2, 2).

* `argument_bytes` equals XLA's `argument_size_in_bytes` exactly.
* FLOPs: the port counts the products (matmuls and attention, by
  `torch.utils.flop_counter`'s formulas, 2 a multiply-add); XLA counts
  those and also every elementwise op, a flop an element. A train step's
  elementwise work is under 1% of its products at these widths, so train
  cells agree within 1% (both count the forward, the recomputed forward
  and the backward). A decode step's elementwise work over its 32k-token
  cache (the mask and the float32 softmax over every cached key, the int8
  cache's dequantization, the writes of each layer's row into the stacked
  cache) is of the order of its products, so a decode cell's count lies
  between 0.4 of XLA's and XLA's plus 1%: the smallest measured ratio is
  0.48 (seqkv, where each of 15 query heads reads one of 5 KV heads of 64
  dims, the fewest products an element of cache).
* Collective bytes by kind are recorded, not gated: GSPMD picks other
  collectives than the port's explicit plan.

The reference module sets ``XLA_FLAGS`` (512 devices) when imported; it
is imported only once jax is up (`emulated_devices`), and the variable is
put back, so the rest of the worker's files keep their 8 devices.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.models import build_model

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

SMOLLM, PHI4, DEEPSEEK = "smollm-360m", "phi4-mini-3.8b", "deepseek-v2-236b"
#: name -> (arch, shape, variant, mesh shape)
CELLS = {
    "smollm-train": (SMOLLM, "train_4k", "baseline", (2, 2)),
    "smollm-decode-seqkv": (SMOLLM, "decode_32k", "seqkv", (2, 2)),
    "phi4-decode-kvq8": (PHI4, "decode_32k", "kvq8", (2, 2)),
    "deepseek-decode": (DEEPSEEK, "decode_32k", "baseline", (2, 2)),
    "smollm-train-multi": (SMOLLM, "train_4k", "baseline", (2, 2, 2)),
}
#: the 1,550,593,540 of the seqkv cell as XLA counts it
SEQKV_ARGUMENT_BYTES = 1_550_593_540
TRAIN_FLOPS_RTOL = 1e-2
DECODE_FLOPS_RANGE = (0.4, 1.01)
RECORD_LAYERS = 3
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "variant", "status", "compile_seconds",
               "cost_raw", "memory", "collectives_raw", "corrected", "model_flops", "roofline"}


@pytest.fixture(scope="module")
def r_dryrun(emulated_devices):
    """The reference's `repro.launch.dryrun`, imported with jax up, its
    import-time ``XLA_FLAGS`` put back."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as r_dryrun

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return r_dryrun


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_with_units_and_full_units(r_dryrun, arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert _fields(cfg) == _fields(rcfg)
    for n in (1, 2, 3):
        assert _fields(dryrun.with_units(cfg, n)) == _fields(r_dryrun.with_units(rcfg, n)), n
    assert dryrun.full_units(cfg) == r_dryrun.full_units(rcfg)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS for s in shp.SHAPES])
def test_count_params_and_model_flops(r_dryrun, arch, shape):
    cfg = shp.shape_config(get_config(arch), shape)
    model = build_model(cfg, device="cpu")
    r_model = r_build_model(r_dryrun.shp.shape_config(r_get_config(arch), shape))
    assert dryrun.count_params(model) == r_dryrun.count_params(r_model)
    spec = shp.input_specs(cfg, shape)
    args = (spec["kind"], spec["global_batch"], spec["seq"])
    assert dryrun.model_flops(model, *args) == r_dryrun.model_flops(r_model, *args)


@pytest.fixture(scope="module")
def lowered(r_dryrun, emulated_devices, tmp_path_factory):
    """(the job's payload, {cell: the reference's (flops, memory analysis,
    collective bytes, bytes accessed)}): the job runs in a thread while
    the reference lowers here."""
    wd = tmp_path_factory.mktemp("dryrun")
    got, errors = {}, []

    def run():
        try:
            got["payload"] = W.run_job("dryrun", 1, wd, timeout_s=300, args=dict(
                cells=[[name, *cell[:3], list(cell[3])] for name, cell in CELLS.items()],
                record=[SMOLLM, "decode_32k", "baseline"], record_layers=RECORD_LAYERS,
                skip=PHI4))[0]
        except AssertionError as e:  # reported below, in the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    for name, (arch, shape, variant, mesh_shape) in CELLS.items():
        names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
        devices = np.array(emulated_devices[: int(np.prod(mesh_shape))]).reshape(mesh_shape)
        mesh = Mesh(devices, names, axis_types=(AxisType.Auto,) * len(mesh_shape))
        compiled, _ = r_dryrun.lower_cell(arch, shape, mesh, units=1, variant=variant)
        cost = compiled.cost_analysis()
        ref[name] = (float(cost["flops"]), compiled.memory_analysis(),
                     r_dryrun.hlo_collective_bytes(compiled.as_text()),
                     float(cost["bytes accessed"]))
    thread.join(330)
    assert not thread.is_alive()
    if errors:
        raise errors[0]
    return got["payload"], ref


@pytest.mark.parametrize("name", CELLS)
def test_argument_bytes_are_xlas(lowered, name):
    payload, ref = lowered
    assert payload["cells"][name]["memory"]["argument"] == ref[name][1].argument_size_in_bytes
    if name == "smollm-decode-seqkv":
        assert payload["cells"][name]["memory"]["argument"] == SEQKV_ARGUMENT_BYTES


@pytest.mark.parametrize("name", CELLS)
def test_flops_within_the_stated_tolerance(lowered, name):
    payload, ref = lowered
    ratio = payload["cells"][name]["flops"] / ref[name][0]
    if CELLS[name][1] == "train_4k":
        assert abs(ratio - 1.0) <= TRAIN_FLOPS_RTOL, ratio
    else:
        lo, hi = DECODE_FLOPS_RANGE
        assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("name", CELLS)
def test_collectives_and_memory_are_recorded(lowered, name):
    """Recorded, not gated against GSPMD's choice: by kind, bytes and
    counts; every cell has some (the meshes split every model); the
    aliased inputs are the ones the step updates, within the arguments.
    Prints both sides' counts (`-s` shows them)."""
    payload, ref = lowered
    cell = payload["cells"][name]
    assert set(cell["collectives"]) == set(cell["counts"]) and cell["collectives"]
    assert all(v > 0 for v in cell["collectives"].values()), cell["collectives"]
    assert set(cell["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                        "all-to-all", "collective-permute"}
    mem = cell["memory"]
    assert 0 < mem["alias"] <= mem["argument"] and mem["output"] > 0 and mem["temp"] > 0
    assert mem["alias"] == ref[name][1].alias_size_in_bytes
    flops, r_mem, r_coll, r_bytes = ref[name]
    print(f"{name}: flops {cell['flops']} / {flops:.0f}; bytes {cell['bytes']} / "
          f"{r_bytes:.0f}; temp {mem['temp']} / {r_mem.temp_size_in_bytes}; "
          f"collectives {cell['collectives']} / {r_coll}")


def test_record_keys_and_corrected_is_the_full_depth_count(lowered):
    """The record carries the reference's keys, and for a uniform stack
    (smollm-360m cut to 3 layers) the 1- and 2-unit extrapolation gives the
    3-layer count itself."""
    rec = lowered[0]["record"]
    assert rec["status"] == "ok", rec.get("error")
    assert RECORD_KEYS <= set(rec)
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s",
                                    "useful_flops_ratio", "dominant"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    corr, raw = rec["corrected"], rec["cost_raw"]
    assert corr["units"] == lowered[0]["record_units"] == RECORD_LAYERS
    assert corr["flops"] == raw["flops"]
    assert corr["bytes"] == raw["bytes"]
    assert corr["collective_bytes"] == sum(rec["collectives_raw"].values())
    assert rec["roofline"]["t_compute_s"] == raw["flops"] / dryrun.PEAK_FLOPS
    assert rec["chips"] == 4


def test_long_context_on_full_attention_is_the_references_skip(lowered):
    rec = lowered[0]["skip"]
    assert rec["status"] == "skip" and rec["reason"] == "SKIP(full-attn)"
