"""Masked attention's dk and dv in float64 on the host, for the card's test
of the backward kernel with a few valid keys and `chip_smoke.py` phase 8.
Imports torch only, no JAX.

`distance_from_float64` holds a kernel's and the plain version's dk, dv
against the float64 gradients, each over that gradient's largest |entry|.
"""
import torch


def distance_from_float64(q, k, v, valid, g, got, plain) -> dict:
    """q, g (B, H, Lq, Dh), k, v (B, H, Lk, Dh), valid (B, Lk) bool, the
    temperature sqrt(Dh); `got` and `plain` each (dq, dk, dv). Returns, for
    dk and dv, the kernel's (`dk`) and the plain version's (`plain_dk`)
    largest distance from float64 over float64's largest |entry|
    (`max_abs_dk`)."""
    invalid = ~valid.cpu()[:, None, None, :]
    qd, kd, vd, gd = (t.double().cpu() for t in (q, k, v, g))
    scale = q.shape[-1] ** 0.5
    p = torch.softmax((qd @ kd.transpose(-1, -2) / scale).masked_fill(invalid, -1e9), -1)
    dp = gd @ vd.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).masked_fill(invalid, 0.0) / scale
    exact = {"dk": ds.transpose(-1, -2) @ qd, "dv": p.transpose(-1, -2) @ gd}
    out = {}
    for name, a, b in (("dk", got[1], plain[1]), ("dv", got[2], plain[2])):
        top = float(exact[name].abs().max())
        out[name] = float((a.double().cpu() - exact[name]).abs().max()) / top
        out[f"plain_{name}"] = float((b.double().cpu() - exact[name]).abs().max()) / top
        out[f"max_abs_{name}"] = top
    return out
