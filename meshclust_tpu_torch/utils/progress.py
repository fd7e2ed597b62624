"""Terminal progress bar (reference Progress.{h,cpp}, SURVEY C13)."""
from __future__ import annotations

import sys


class Progress:
    def __init__(self, total: int, label: str, stream=None, width: int = 40):
        self.total = max(1, int(total))
        self.label = label
        self.count = 0
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self._last_pct = -1
        self._draw()

    def _draw(self) -> None:
        pct = int(100 * self.count / self.total)
        if pct == self._last_pct:
            return
        self._last_pct = pct
        filled = int(self.width * self.count / self.total)
        bar = "=" * filled + ">" + " " * (self.width - filled)
        self.stream.write(f"\r{self.label} [{bar}] {pct:3d} %")
        self.stream.flush()

    def update(self, n: int = 1) -> None:
        self.count += n
        self._draw()

    def end(self) -> None:
        self.count = self.total
        self._draw()
        self.stream.write("\n")
        self.stream.flush()

    def __iadd__(self, n: int):
        self.update(n)
        return self
