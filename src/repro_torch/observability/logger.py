"""SUNLogger analog: leveled, structured, JSON-lines event logging.

Counterpart of ``repro.observability.logger``.  Each event is one JSON
object, kept in a bounded in-memory deque and, when a sink is given,
written as one line to it.  Host code logs around the step loops, never
inside them: step data goes to the ring of
:mod:`repro_torch.observability.telemetry`.  A disabled logger
(``level=None``) drops every event after one threshold check.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import IO, Callable, Optional

#: SUNLogger's four levels, ranked; an event is kept when its level
#: ranks at or above the configured threshold.
LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}


class EventLogger:
    """Leveled structured event log (JSON lines + in-memory deque)."""

    def __init__(self, level: Optional[str] = None,
                 path: Optional[str] = None,
                 stream: Optional[IO] = None,
                 clock: Callable[[], float] = time.time,
                 keep: int = 10_000):
        if level is not None and level.upper() not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; "
                             f"levels: {sorted(LEVELS)}")
        self.threshold = None if level is None else LEVELS[level.upper()]
        self.clock = clock
        self.events: deque = deque(maxlen=keep)
        self._own_fh = None
        if path is not None:
            self._own_fh = open(path, "a")
            self._fh = self._own_fh
        else:
            self._fh = stream

    @property
    def enabled(self) -> bool:
        return self.threshold is not None

    def enabled_for(self, level: str) -> bool:
        return (self.threshold is not None
                and LEVELS[level] >= self.threshold)

    def log(self, level: str, event: str, **fields) -> None:
        """Record one structured event (dropped below the threshold)."""
        if self.threshold is None or LEVELS[level] < self.threshold:
            return
        rec = {"ts": round(self.clock(), 6), "level": level,
               "event": event, **fields}
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, default=str) + "\n")
            self._fh.flush()

    def error(self, event: str, **fields) -> None:
        self.log("ERROR", event, **fields)

    def warning(self, event: str, **fields) -> None:
        self.log("WARNING", event, **fields)

    def info(self, event: str, **fields) -> None:
        self.log("INFO", event, **fields)

    def debug(self, event: str, **fields) -> None:
        self.log("DEBUG", event, **fields)

    def close(self) -> None:
        if self._own_fh is not None:
            self._own_fh.close()
            self._own_fh = None
            self._fh = None
