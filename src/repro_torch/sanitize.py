"""Runtime guard for resident serving state (the port's ``repro.sanitize``).

Only :class:`ThreadAffinityGuard` is ported.  The JAX package's
``DonationGuard`` / ``guard_donated`` poison buffers donated to a jitted
call; the port has no donation (it updates resident state in place), so
they have no counterpart here.
"""

from __future__ import annotations

import threading

from repro_torch import obs


class ThreadAffinityGuard:
    """Reject concurrent entry into a resident-state critical region.

    Re-entrant for the OWNING thread (depth-counted); entry from any
    other thread while held raises ``RuntimeError`` and increments
    ``trips`` — the counter ``ServeResult.guard_trips`` surfaces.
    """

    def __init__(self, name: str):
        self.name = name
        self.trips = 0
        self._owner: int | None = None
        self._depth = 0
        self._mu = threading.Lock()

    def __enter__(self):
        me = threading.get_ident()
        with self._mu:
            if self._owner is None or self._owner == me:
                self._owner = me
                self._depth += 1
                return self
            self.trips += 1
            obs.inc("sanitize.guard_trips")
            raise RuntimeError(
                f"{self.name}: concurrent entry from thread {me} while "
                f"thread {self._owner} holds the resident state — "
                "ServeEngine ingest/advance/query must not run "
                "concurrently from multiple threads (serialize callers "
                "or run one engine per thread)")

    def __exit__(self, *exc):
        with self._mu:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
        return False
