"""The check of a PSNR target (`Policy.fixed_psnr`): each sampled answer's
value range, and the decoded sample against the controller's solved
bound and against the target.

* ``vr_gap`` — each sampled answer's value range (the PSNR's yardstick)
  against the field's, in float64, relative, worst answer: an answer made
  from other data than its request's reads here.
* ``err_excess`` — by how much the largest pointwise error exceeds the
  solved bound of the chosen codec, over that bound (0 where it holds):
  float32 quantization on the device leaves ~1e-5 where SZ sits at its
  bound.
* ``psnr_gap_db`` — how far the decoded field's value-range PSNR lies
  from the target, in dB: the end-to-end test of the solved bound.
"""

import math

from portbench import oracle


def numbers(cell, ledger, inputs, log=print) -> dict:
    target = float(cell.traffic["policy"]["target_psnr"])
    vr_gap = 0.0
    for a in ledger.decided():
        vr_gap = max(vr_gap, abs(a.vr / oracle.value_range(inputs.host(a.request, a.name)) - 1.0))
    excess = gap = 0.0
    n = 0
    for request, name, codec, sel, x, diff in oracle.decoded(ledger, inputs, log):
        n += 1
        if diff is None:
            excess = gap = math.inf
            continue
        e = float(diff.max()) / oracle.codec_bound(codec, sel)
        vr = oracle.value_range(x)
        psnr = -10.0 * math.log10(max(float((diff * diff).mean()), 1e-300) / (vr * vr))
        log(f"check: request {request} field {name} max|err| over the codec's bound {e!r}, "
            f"PSNR {psnr!r} dB")
        excess = max(excess, e - 1.0)
        gap = max(gap, abs(psnr - target))
    if not n:
        excess = gap = math.inf  # nothing came back to decode
    return {"vr_gap": vr_gap, "err_excess": max(excess, 0.0), "psnr_gap_db": gap}
