"""Phase timing: the wall clock of each named phase of a fit
(model_fit(timing=True) attaches one as fit.timing)."""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


class PhaseTimer:
    """Accumulates wall-clock per named phase; printable summary.

    sync: called before each clock read (torch.cuda.synchronize for a fit
    on a card, so a phase owns the device work it launched)."""

    def __init__(self, sync=None):
        self.times = OrderedDict()
        self._sync = sync or (lambda: None)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"{name:<28} {t:>9.3f}s {100 * t / max(total, 1e-12):5.1f}%"
                 for name, t in self.times.items()]
        lines.append(f"{'total':<28} {total:>9.3f}s")
        return "\n".join(lines)
