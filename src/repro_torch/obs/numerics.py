"""Hybrid-format telemetry: per-burst numeric stats on the device and the
host accumulator that folds them into a run summary.

The PyTorch counterpart of ``repro.obs.numerics``.  The paper's claim is
that hybrid fp/fixed formats hold accuracy because the realized dynamic
range of softmax inputs (after the max subtraction) and of KV rows is
narrow; these functions measure that range while serving:

  logit_stats / reduce_logit_stats
      the exponent range of the sampling logits before and after the max
      subtraction, a few row reductions per step on the device (a NaN in a
      poisoned burst propagates into z_max, which is the explanation a
      quarantine wants)
  format_stats
      fp2fx8 KV telemetry over the port's cache dict ``{"blocks": {"k",
      "v", "k_scale", "v_scale"}}`` (dense or paged): int8 saturation
      counts (|raw| == 127, the clip level of ``fp2fx8_quantize``) and a
      64-bin power-of-two histogram of the per-row scales (written rows
      only: scale 0 is an untouched position, e.g. an unallocated page)
  NumericsMonitor
      the host accumulator.  A burst's stats stay on the device until the
      burst ends; ``update`` reads them in one transfer (only when
      ``ServeConfig.telemetry`` is on), keeps the latest burst's scalars
      (``last``) so a quarantine can be annotated with the numbers that
      triggered it, and counts the fp -> fx convert volume of the KV
      quantize on write.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

F32 = torch.float32
SCALE_BINS = 64
# bin = floor(log2(scale)) + offset, clipped to [0, SCALE_BINS); offset 40
# centres the fp2fx8 regime (scales ~2^-12..2^-2 for unit-variance KV)
SCALE_BIN_OFFSET = 40
_INT8_SAT = 127  # |raw| at the fp2fx8_quantize clip level


def logit_stats(logits: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Per-step exponent-range stats of the sampling logits.

    logits: (B, V) float, active: (B,) bool.  Returns a (3,) fp32 tensor
    [z_max, z_min, zsub_min] over active rows, zsub_min the minimum of
    z - max(z), the softmax input range after the max subtraction.
    Inactive rows contribute neutral values; NaNs propagate."""
    x = logits.to(F32)
    row_max = x.amax(-1)
    row_min = x.amin(-1)
    sub_min = row_min - row_max
    inf = torch.tensor(math.inf, dtype=F32, device=x.device)
    z_max = torch.where(active, row_max, -inf).amax()
    z_min = torch.where(active, row_min, inf).amin()
    zs_min = torch.where(active, sub_min, inf).amin()
    return torch.stack([z_max, z_min, zs_min])


def reduce_logit_stats(per_step: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Reduce stacked (T, 3) per-step stats to one burst dict."""
    return {"z_max": per_step[:, 0].amax(), "z_min": per_step[:, 1].amin(),
            "zsub_min": per_step[:, 2].amin()}


def _named_leaves(tree, name=""):
    """(key, tensor) for every tensor leaf of a nested dict, the key the
    leaf's own, in sorted key order (the JAX tree's leaf order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    elif torch.is_tensor(tree):
        yield name, tree


def format_stats(cache) -> Dict[str, torch.Tensor]:
    """fp2fx8 KV telemetry over a cache dict, on the cache's device.

    int8 leaves feed the saturation count; ``*_scale`` leaves feed the
    power-of-two scale histogram and min/max (zero scales, unwritten
    positions, are skipped).  Returns {} for an unquantized cache."""
    leaves = list(_named_leaves(cache))
    if not any(t.dtype == torch.int8 for _, t in leaves):
        return {}
    dev = leaves[0][1].device
    sat = torch.zeros((), dtype=torch.int64, device=dev)
    hist = torch.zeros(SCALE_BINS, dtype=torch.int64, device=dev)
    smin = torch.tensor(math.inf, dtype=F32, device=dev)
    smax = torch.tensor(0.0, dtype=F32, device=dev)
    for name, leaf in leaves:
        if leaf.dtype == torch.int8:
            sat = sat + (leaf.to(torch.int32).abs() >= _INT8_SAT).sum()
        elif name.endswith("_scale"):
            s = leaf.to(F32).reshape(-1)
            written = s > 0
            e = torch.clamp(torch.floor(torch.log2(torch.clamp(s, min=1e-45)))
                            .to(torch.int32) + SCALE_BIN_OFFSET, 0, SCALE_BINS - 1)
            hist = hist + torch.bincount(e[written], minlength=SCALE_BINS)
            smin = torch.minimum(smin, torch.where(written, s, math.inf).amin())
            smax = torch.maximum(smax, s.amax())
    return {"kv_saturated": sat, "kv_scale_hist": hist, "kv_scale_min": smin,
            "kv_scale_max": smax}


def int8_size(cache) -> int:
    """Host-side count of the int8 cache elements (the saturation base)."""
    return sum(t.numel() for _, t in _named_leaves(cache) if t.dtype == torch.int8)


def _to_host(tstats) -> Dict[str, np.ndarray]:
    """A stats dict of device tensors as numpy arrays, in one transfer:
    every value widened to float64 (fp32 values and counts below 2**53 stay
    exact), concatenated, read back, split."""
    if not any(torch.is_tensor(v) for v in tstats.values()):
        return {k: np.asarray(v) for k, v in tstats.items()}
    keys = sorted(tstats)
    flat = [tstats[k].reshape(-1).to(torch.float64) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for k, t in zip(keys, flat):
        v = host[i:i + t.numel()]
        out[k] = v if tstats[k].ndim else v[0]
        i += t.numel()
    return out


class NumericsMonitor:
    """Host accumulator for per-burst telemetry dicts."""

    def __init__(self):
        self.bursts = 0
        self.z_max = -math.inf
        self.z_min = math.inf
        self.zsub_min = math.inf
        self.kv_saturated = 0
        self.kv_int8_total = 0
        self.kv_scale_hist = np.zeros(SCALE_BINS, dtype=np.int64)
        self.kv_scale_min = math.inf
        self.kv_scale_max = 0.0
        self.converts = 0
        self.last: Dict[str, float] = {}
        self.quarantine_events: List[dict] = []

    def update(self, tstats) -> Dict[str, float]:
        """Fold one burst's stats dict (device tensors: read back here, in
        one transfer); returns this burst's host scalars (also ``last``)."""
        if not tstats:
            return {}
        d = _to_host(tstats)
        self.bursts += 1
        last: Dict[str, float] = {}
        if "z_max" in d:
            zmax = float(d["z_max"])
            zmin = float(d["z_min"])
            zsub = float(d["zsub_min"])
            last.update(z_max=zmax, z_min=zmin, zsub_min=zsub)
            # a NaN-poisoned burst leaves the running range untouched but
            # stays visible in ``last`` (and so in quarantine annotations)
            if math.isfinite(zmax):
                self.z_max = max(self.z_max, zmax)
            if math.isfinite(zmin):
                self.z_min = min(self.z_min, zmin)
            if math.isfinite(zsub):
                self.zsub_min = min(self.zsub_min, zsub)
        if "kv_saturated" in d:
            sat = int(d["kv_saturated"])
            self.kv_saturated = sat  # cache-wide count, latest wins
            self.kv_scale_hist = d["kv_scale_hist"].astype(np.int64)
            smin = float(d["kv_scale_min"])
            smax = float(d["kv_scale_max"])
            if math.isfinite(smin):
                self.kv_scale_min = min(self.kv_scale_min, smin)
            self.kv_scale_max = max(self.kv_scale_max, smax)
            last.update(kv_saturated=sat, kv_scale_min=smin,
                        kv_scale_max=smax)
        self.last = last
        return last

    def add_converts(self, n: int) -> None:
        self.converts += int(n)

    def record_quarantine(self, rid, where: str) -> dict:
        """Annotate a quarantine decision with the most recent burst's
        numeric stats (the numbers that triggered the ladder)."""
        ev = {"rid": rid, "where": where, **self.last}
        self.quarantine_events.append(ev)
        return ev

    def summary(self) -> dict:
        def _f(v):
            return v if math.isfinite(v) else None

        out = {
            "bursts": self.bursts,
            "z_max": _f(self.z_max) if self.bursts else None,
            "z_min": _f(self.z_min) if self.bursts else None,
            "zsub_min": _f(self.zsub_min) if self.bursts else None,
            "converts": self.converts,
        }
        if self.kv_scale_hist.any() or self.kv_int8_total:
            nz = np.nonzero(self.kv_scale_hist)[0]
            out.update({
                "kv_saturated": self.kv_saturated,
                "kv_int8_total": self.kv_int8_total,
                "kv_saturation_rate": (
                    self.kv_saturated / self.kv_int8_total
                    if self.kv_int8_total else 0.0),
                "kv_scale_min": _f(self.kv_scale_min),
                "kv_scale_max": self.kv_scale_max,
                # sparse histogram: {exponent: count}, exponent = log2(scale)
                "kv_scale_hist": {
                    int(i - SCALE_BIN_OFFSET): int(self.kv_scale_hist[i])
                    for i in nz},
            })
        if self.quarantine_events:
            out["quarantine_events"] = list(self.quarantine_events)
        return out
