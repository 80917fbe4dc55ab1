"""The check of a pointwise-bound policy (`Policy.fixed_accuracy`):
Algorithm 1's decision on every sampled answer, and the decoded error.

* ``eb_gap`` — each answer's bound against eb_rel x the field's value
  range, relative, worst answer.
* ``decision_gap`` — each answer's estimated SZ and ZFP bit-rates and its
  SZ bound against the reference's Algorithm 1 (`refselect.decide`) on the
  same field, relative, and the reference's rate of the chosen codec over
  its best rate, less 1 (the regret of the choice); the worst answer's
  largest.
* ``err_over_eb`` — on the decoded sample, the largest pointwise error
  over the user's bound. The configuration states the limit, 1.
* ``err_excess`` — on the same sample, by how much the largest pointwise
  error exceeds the bound of the chosen codec (SZ's own bound, ZFP's the
  user's), over the user's bound; 0 where it holds. A stream coded looser
  than its decision says shows here. (Over the user's bound, not SZ's
  own: the float32 rounding of a reconstruction is a share of the value
  range, which can be a percent of a small SZ bound.)
"""

import math

from portbench import oracle, refselect


def numbers(cell, ledger, inputs, log=print) -> dict:
    eb_rel = float(cell.traffic["policy"]["eb_rel"])
    eb_gap = dec_gap = 0.0
    for a in ledger.decided():
        r = refselect.decide(inputs.host(a.request, a.name), eb_rel)
        eb_gap = max(eb_gap, abs(a.eb_abs / r["eb_abs"] - 1.0))
        best = min(r["br_sz"], r["br_zfp"])
        chosen = {"sz": r["br_sz"], "zfp": r["br_zfp"]}.get(a.codec, 32.0)
        dec_gap = max(dec_gap, abs(a.br_sz / r["br_sz"] - 1.0), abs(a.br_zfp / r["br_zfp"] - 1.0),
                      abs(a.eb_sz / r["eb_sz"] - 1.0), chosen / best - 1.0)
    over = excess = 0.0
    n = 0
    for request, name, codec, sel, x, diff in oracle.decoded(ledger, inputs, log):
        n += 1
        if diff is None:
            over = excess = math.inf
            continue
        e = float(diff.max())
        user = eb_rel * oracle.value_range(x)
        over = max(over, e / user)
        excess = max(excess, (e - oracle.codec_bound(codec, sel)) / user)
        log(f"check: request {request} field {name} max|err| {e!r}, over the user's bound "
            f"{e / user!r}, over the codec's {e / oracle.codec_bound(codec, sel)!r}")
    if not n:
        over = excess = math.inf  # nothing came back to decode
    return {"eb_gap": eb_gap, "decision_gap": dec_gap, "err_over_eb": over, "err_excess": excess}
