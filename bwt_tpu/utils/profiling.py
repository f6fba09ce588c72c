"""Tracing / profiling subsystem.

The reference's only instrumentation is a raw rdtsc macro wrapped
around build and query phases with a hardcoded 2.5 GHz cycles-to-
seconds conversion (rdtscll.h:16-18, fmitest.c:143-149,
searchtest.c:94).  The device replacements:

  * :class:`Phases` — wall-clock phase timers with derived rates
    (bases/s, reads/s), the structured equivalent of the reference's
    printf'd cycle counts;
  * :func:`device_trace` — a JAX profiler trace (XPlane/Perfetto)
    around a region, viewable in TensorBoard or ui.perfetto.dev.
"""

from __future__ import annotations

import contextlib
import time


class Phases:
    """Accumulating wall-clock phase timers.

    >>> ph = Phases()
    >>> with ph("build"):
    ...     build()
    >>> ph.rate("build", genome_len)   # bases/s
    >>> print(ph.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def seconds(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def rate(self, name: str, units: float) -> float:
        """units processed per second in phase ``name`` (0 if unrun)."""
        dt = self.totals.get(name, 0.0)
        return units / dt if dt else 0.0

    def report(self) -> str:
        width = max((len(n) for n in self.totals), default=0)
        return "\n".join(
            f"{n:<{width}}  {self.totals[n]*1e3:10.2f} ms  x{self.counts[n]}"
            for n in self.totals
        )


# Optional process-wide span collector: tools/profile_phases.py (and
# friends) assign a Phases here; instrumented host paths in the models
# wrap their stages in span(), which no-ops when unset.
ACTIVE: Phases | None = None


class _noop_span:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _noop_span()


def span(name: str):
    """A timing context for stage ``name`` against the ACTIVE Phases
    collector (no-op when profiling is off)."""
    return ACTIVE(name) if ACTIVE is not None else _NOOP


@contextlib.contextmanager
def device_trace(logdir: str):
    """JAX profiler trace around a region; writes an XPlane/Perfetto
    trace under ``logdir`` (inspect with TensorBoard's profile plugin
    or perfetto).  A failure to start or stop the trace raises."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``, one line per card).  Runs ``nvidia-smi`` as
    a child process, which touches neither JAX nor the card's memory;
    raises if it fails."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
