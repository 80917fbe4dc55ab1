"""The check against the control and against planted faults, driving the
rest of a run on the CPU at a small size (no chip is looked for): each
must come out not correct, while the sound run comes out correct.

The control is the timed path fed the fields rounded to bfloat16 (the
precision below the configurations' float32). The faults are those a
compression cell can have: an answer altered where it is produced (a
stream's byte, the codec of a decision, or a stream coded looser than its
decision says), half of a request's fields left out, and a request that
returns an earlier result for fields of the same names (a cache by name,
which every new snapshot must defeat). One chip, so no exchange between
chips to leave out.
"""

import time
from dataclasses import replace

import pytest
import torch

from portbench import spec
from portbench.harness import program_compress, run_cell
from portbench.readings import control_compress

CPU = torch.device("cpu")
SMALL = {"atm-e4": (256, 512), "hurricane-e4": (32, 64, 64), "atm-psnr60": (512, 1024)}
#: fields a snapshot in these tests: every fifth of ATM's 79, all of Hurricane's 13
STRIDE = {"cesm-atm": 5, "hurricane-isabel": 1}


def _run(cell_name, compress=None, seed=2**31 + 77):
    cell = spec.load_cell(cell_name)
    cfg = dict(cell.config)
    cfg["fields"] = cfg["fields"][:: STRIDE[cfg["name"]]]
    cell = replace(cell, config=cfg)
    return run_cell(cell, seed, 0.0, False, device=CPU, t0=time.perf_counter(),
                    compress=compress, shape=SMALL[cell_name], min_requests=2,
                    log=lambda m: None)


def _failing(res):
    return {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_the_control_is_not(cell):
    sound = _run(cell)
    assert sound["correct"], sound["checks"]
    assert set(sound["metrics"]) == {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert {"ratio", "setup_s"} <= set(sound["metrics"])
    ctl = _run(cell, control_compress(CPU))
    assert not ctl["correct"]
    assert {"err_over_eb", "err_excess"} & _failing(ctl)


def _altered_stream():
    prog = program_compress(CPU)

    def compress(fields, policy):
        tree = prog(fields, policy)
        for cf in tree.fields.values():
            b = bytearray(cf.data)
            b[len(b) // 2] ^= 0x5A
            cf.data = bytes(b)
        return tree

    return compress


def _half_left_out():
    prog = program_compress(CPU)

    def compress(fields, policy):
        keep = dict(list(fields.items())[: len(fields) // 2])
        return prog(keep, policy)

    return compress


def _cached_by_name():
    prog = program_compress(CPU)
    seen = {}

    def compress(fields, policy):
        key = tuple(fields)
        if key not in seen:
            seen[key] = prog(fields, policy)
        return seen[key]

    return compress


@pytest.mark.parametrize("fault,fails", [
    (_altered_stream, {"err_over_eb", "err_excess"}),
    (_half_left_out, {"missing"}),
    (_cached_by_name, {"eb_gap", "decision_gap"}),
])
def test_faults_are_caught(fault, fails):
    res = _run("hurricane-e4", fault())
    assert not res["correct"]
    assert fails <= _failing(res)


def test_a_cache_by_name_is_caught_under_a_psnr_target():
    res = _run("atm-psnr60", _cached_by_name())
    assert not res["correct"]
    assert {"err_excess", "psnr_gap_db"} & _failing(res)


def test_a_stream_coded_looser_than_its_decision_is_caught(monkeypatch):
    from repro_torch.core import api

    encode = api.encode_with_selection

    def looser(x, sel, **kwargs):
        cf = encode(x, replace(sel, eb_sz=sel.eb_abs), **kwargs)
        cf.selection = sel
        return cf

    monkeypatch.setattr(api, "encode_with_selection", looser)
    res = _run("atm-e4")
    assert not res["correct"]
    assert "err_excess" in _failing(res)


def test_a_swapped_codec_is_caught(monkeypatch):
    from repro_torch.core import api

    select_many = api.select_many

    def swapped(*args, **kwargs):
        return [replace(s, codec={"sz": "zfp", "zfp": "sz"}.get(s.codec, s.codec))
                for s in select_many(*args, **kwargs)]

    monkeypatch.setattr(api, "select_many", swapped)
    res = _run("hurricane-e4")
    assert not res["correct"]
    assert "decision_gap" in _failing(res)
