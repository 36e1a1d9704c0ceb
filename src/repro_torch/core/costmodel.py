"""Fabric-free hardware cost model — reproduces the *structure* of paper Table 3.

Own copy of ``repro.core.costmodel`` (pure Python, no JAX): the same
primitives, weights and rows, so ``table3()`` gives the JAX package's
numbers exactly.

LUT/FF/F_max are FPGA-fabric quantities with no GPU meaning, but they are
driven by countable primitive operations.  We count those primitives per
softmax variant and weight them with standard relative-area/delay factors
(barrel shifter ~ W log W, W-bit multiplier ~ W^2, fixed add ~ W, FP add ~
shifter+add+LOD, divider ~ W cycles of sub/shift).  The *ordering* and the
rough ratios of Table 3 (Hyft ~15x fewer resources, ~20x lower latency than
the Xilinx FP32 engine) are the reproducible claims.

Latency model: three stages (max | exp+sum | div) pipelined across vectors
(paper §3.6, Fig. 6); per-vector latency = sum of stage critical paths,
steady-state throughput = 1 / max(stage delay).
"""
from __future__ import annotations

import dataclasses
import math


# relative area (a) and delay (d) of primitive blocks at width W, normalized
# to a W-bit fixed adder = (area W, delay log2 W). Standard synthesis folklore
# constants; absolute values are irrelevant, ratios matter.
def _adder(W):      return dict(a=W,                 d=math.log2(W))
def _shifter(W):    return dict(a=W * math.log2(W),  d=math.log2(W))
def _cmp(W):        return dict(a=W,                 d=math.log2(W))
def _mul(W, W2=None):
    W2 = W2 or W
    return dict(a=W * W2,            d=math.log2(W) + math.log2(max(W2, 2)))
def _lod(W):        return dict(a=W,                 d=math.log2(W))
def _divider(W):    return dict(a=3 * W * W,         d=W * math.log2(W))  # restoring
def _lut(bits, out):return dict(a=(2 ** bits) * out / 64.0, d=2.0)
def _fp_add(W):
    # align shifter + add + renorm LOD + shifter
    s, a, l = _shifter(W), _adder(W), _lod(W)
    return dict(a=2 * s["a"] + a["a"] + l["a"], d=2 * s["d"] + a["d"] + l["d"])
def _fp_mul(W):
    m, a = _mul(W // 2 + 1), _adder(W // 4)  # mantissa mul + exp add
    return dict(a=m["a"] + a["a"], d=m["d"] + a["d"])


@dataclasses.dataclass
class Cost:
    area: float = 0.0
    stage_delays: tuple = (0.0, 0.0, 0.0)

    @property
    def latency(self):  # one-vector latency (ns-like units)
        return sum(self.stage_delays)

    @property
    def throughput_period(self):  # pipelined: limited by slowest stage
        return max(self.stage_delays)


def _acc(*items):
    return sum(i["a"] for i in items)


def _seq(*items):
    return sum(i["d"] for i in items)


def hyft_cost(N: int = 8, W: int = 16, step: int = 1) -> Cost:
    """Hyft: fixed-point max/sub/booth + field-assembled exp + fixed adder tree
    + field-subtract division.  No FP adds, no divider, no exp LUT."""
    F = W - 6
    # stage 1: strided max search (fixed cmp tree over N/step) + FP2FX banks
    n1 = max(N // step, 1)
    st1_a = (n1 - 1) * _cmp(W)["a"] + (N + 1) * _shifter(W)["a"] * 0.5  # FP2FX ~ half shifter
    st1_d = math.ceil(math.log2(max(n1, 2))) * _cmp(W)["d"] + _shifter(W)["d"] * 0.5
    # stage 2: per-elem fixed sub + booth (2 shifts hardwired = wiring, 2 adds)
    #          + FX2FP assembly (wiring) + FP2FX (shift by exponent) + adder tree
    per_elem = 3 * _adder(W)["a"] + _shifter(W)["a"]
    st2_a = N * per_elem + (N - 1) * _adder(W + math.ceil(math.log2(N)))["a"] + _lod(W)["a"]
    st2_d = _seq(_adder(W), _adder(W), _shifter(W)) + \
        math.ceil(math.log2(N)) * _adder(W)["d"] + _lod(W)["d"]
    # stage 3: division = exp sub + mantissa sub + 1-bit renorm mux, per element
    st3_a = N * 2 * _adder(F)["a"]
    st3_d = 2 * _adder(F)["d"]
    return Cost(st1_a + st2_a + st3_a, (st1_d, st2_d, st3_d))


def xilinx_fp_cost(N: int = 8, W: int = 32) -> Cost:
    """All-FP32 engine: FP cmp max, FP sub, FP exp (poly, ~5 FP mul+add),
    FP adder tree, FP divider."""
    st1_a = (N - 1) * _fp_add(W)["a"]
    st1_d = math.ceil(math.log2(N)) * _fp_add(W)["d"]
    exp_a = 5 * (_fp_mul(W)["a"] + _fp_add(W)["a"])
    exp_d = 5 * (_fp_mul(W)["d"] + _fp_add(W)["d"])
    st2_a = N * (_fp_add(W)["a"] + exp_a) + (N - 1) * _fp_add(W)["a"]
    st2_d = _fp_add(W)["d"] + exp_d + math.ceil(math.log2(N)) * _fp_add(W)["d"]
    st3_a = N * _divider(24)["a"] / 4  # shared pipelined divider bank
    st3_d = _divider(24)["d"]
    return Cost(st1_a + st2_a + st3_a, (st1_d, st2_d, st3_d))


def fixed_lut_cost(N: int = 8, W: int = 16) -> Cost:
    """[25]-style all-fixed: LUT exp + fixed adds + restoring divider."""
    st1_a = (N - 1) * _cmp(W)["a"]
    st1_d = math.ceil(math.log2(N)) * _cmp(W)["d"]
    st2_a = N * (_adder(W)["a"] + _lut(8, W)["a"]) + (N - 1) * _adder(W)["a"]
    st2_d = _adder(W)["d"] + 2.0 + math.ceil(math.log2(N)) * _adder(W)["d"]
    st3_a = N * _divider(W)["a"] / 4
    st3_d = _divider(W)["d"]
    return Cost(st1_a + st2_a + st3_a, (st1_d, st2_d, st3_d))


def base2_cost(N: int = 8, W: int = 16) -> Cost:
    """[29]: like Hyft stage structure but no Booth (base-2), shift division."""
    c = hyft_cost(N, W)
    st1, st2, st3 = c.stage_delays
    # no booth adds in stage 2; division is a shift (power-of-2 divisor)
    return Cost(c.area * 0.9, (st1, st2 - 2 * _adder(W)["d"], _shifter(W)["d"]))


def table3(N: int = 8) -> list[dict]:
    rows = []
    for name, cost, W in [
        ("xilinx_fp32", xilinx_fp_cost(N, 32), 32),
        ("fixed_lut16 [25]", fixed_lut_cost(N, 16), 16),
        ("base2 [29]", base2_cost(N, 16), 16),
        ("hyft16", hyft_cost(N, 16), 16),
        ("hyft16_step2", hyft_cost(N, 16, step=2), 16),
        ("hyft32", hyft_cost(N, 24), 32),
    ]:
        rows.append(dict(name=name, N=N, W=W, area=cost.area,
                         latency=cost.latency, period=cost.throughput_period,
                         fom=N * W / (cost.area * cost.throughput_period)))
    base = next(r for r in rows if r["name"] == "xilinx_fp32")
    for r in rows:
        r["area_ratio_vs_fp32"] = base["area"] / r["area"]
        r["latency_ratio_vs_fp32"] = base["latency"] / r["latency"]
    return rows
