"""Paper Table 3 (hardware cost), on the port: the op-count cost model.

The counterpart of ``benchmarks/table3_hardware.py``: area, latency,
period and FOM per softmax design at N = 8, W = 16/32, from
``repro_torch.core.costmodel`` (pure Python), so the rows equal the JAX
package's to the printed digit on any device.
"""
from __future__ import annotations

from repro_torch.core.costmodel import table3
from repro_torch.device import resolve_device


def run(report, device=None):
    resolve_device(device)   # the proxies' one contract: the card unless asked
    for r in table3(N=8):
        report(
            f"table3,{r['name']},area={r['area']:.0f},latency={r['latency']:.1f},"
            f"period={r['period']:.1f},fom={r['fom'] * 1000:.2f},"
            f"area_x_fp32={r['area_ratio_vs_fp32']:.1f},"
            f"latency_x_fp32={r['latency_ratio_vs_fp32']:.1f}")
