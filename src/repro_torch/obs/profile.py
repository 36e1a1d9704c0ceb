"""The ``--xla-profile`` capture window, on ``torch.profiler``.

The JAX module (``repro.obs.profile``) holds three things: ``xla_profile``,
a ``jax.profiler`` capture window; ``CostBook``, the per-executable cost
ledger built on XLA's HLO cost analysis and the TPU roofline; and
``microbench``.  Only the window is here.  The cost book and the
microbench belong to the port's benches (ROADMAP queue 1, the rest of
obs/ and port benches): they rest on XLA's cost analysis, which PyTorch
does not have, so the port's ``--trace`` carries no ``roofline.*``
counter tracks yet.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def xla_profile(outdir: Optional[str]) -> Iterator[None]:
    """The ``torch.profiler`` counterpart of the JAX package's
    ``xla_profile``: profile the CPU and, where there is one, the card
    while inside, then write the Chrome trace to ``outdir/trace.json``
    (load it in ui.perfetto.dev).  A no-op when ``outdir`` is falsy, so
    call sites pass the ``--xla-profile`` flag through unconditionally."""
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))
