"""Host-side progress reporting, standing in for the reference's bubbletea
progress bar + stopwatch (internal/progress/progress.go:19-91)."""

from __future__ import annotations

import sys
import time


class Bar:
    def __init__(self, total: int, enabled: bool = True, width: int = 40):
        self.total = max(total, 1)
        self.done = 0
        self.enabled = enabled
        self.width = width
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1):
        self.done += n
        if not self.enabled:
            return
        frac = min(self.done / self.total, 1.0)
        filled = int(frac * self.width)
        elapsed = time.perf_counter() - self.t0
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        sys.stderr.write(
            f"\r[{'#' * filled}{'.' * (self.width - filled)}] "
            f"{self.done}/{self.total} {elapsed:6.1f}s eta {eta:6.1f}s")
        sys.stderr.flush()

    def close(self):
        if self.enabled:
            elapsed = time.perf_counter() - self.t0
            sys.stderr.write(f"\rdone in {elapsed:.1f}s{' ' * self.width}\n")
            sys.stderr.flush()
