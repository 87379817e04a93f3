"""Logging / profiling substrate.

Mirrors the observability contract of the reference's libimsux logger +
``stop_watch``/``comma_sep`` MB/s instrumentation (reference
``oipshared.h:70-84``, ``main.cpp:319-329``): a trace-level file logger
(path from the ``LOGFILE`` env var, default ``oip.log``), timestamped lines,
and per-stage throughput reports wrapped around every I/O and compute stage.

Additions over the reference: stage timings are also accumulated into a
process-wide registry (:func:`stage_report`) so benchmarks and tests can
assert on them, and :func:`trace_annotation` plugs into the JAX profiler.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from dataclasses import dataclass, field


def comma_sep(value) -> str:
    """Format numbers with thousands separators, like libimsux ``comma_sep``."""
    if isinstance(value, float):
        return f"{value:,.3f}"
    return f"{value:,}"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("oiptpu")
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d [%(levelname).1s] %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    logfile = os.environ.get("LOGFILE", "oip.log")
    try:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        fh.setLevel(logging.DEBUG)
        logger.addHandler(fh)
    except OSError:
        pass
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    sh.setLevel(
        logging.DEBUG if os.environ.get("OIP_VERBOSE") else logging.WARNING
    )
    logger.addHandler(sh)
    return logger


LOG = _build_logger()


def olog(msg: str, *args) -> None:
    """Trace log (reference ``OLOG`` macro)."""
    LOG.debug(msg, *args)


def rlog(msg: str, *args) -> None:
    """Raw table-row log (reference ``RLOG``): the de-facto QA report rows."""
    LOG.debug(msg, *args)


def logw(msg: str, *args) -> None:
    LOG.warning(msg, *args)


def loge(msg: str, *args) -> None:
    LOG.error(msg, *args)


@dataclass
class _StageStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0


_STAGES: dict[str, _StageStats] = {}


@dataclass
class StopWatch:
    """Per-stage wall-clock + MB/s instrumentation (libimsux ``stop_watch``)."""

    t0: float = field(default_factory=time.perf_counter)

    def rst(self) -> None:
        self.t0 = time.perf_counter()

    def tik(self) -> float:
        return time.perf_counter() - self.t0

    tick = tik


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0, log: bool = True):
    """Time a pipeline stage and log ``<bytes> in <secs> (<MBps>)``.

    This is the equivalent of the reference's ubiquitous
    ``stop_watch::rst()/tik()`` + MB/s OLOG pattern (e.g. imageop.h:116-125).
    Every stage is also emitted as a JAX profiler TraceAnnotation, so
    device traces show the pipeline stage structure.
    """
    sw = StopWatch()
    try:
        with trace_annotation(name):
            yield sw
    finally:
        es = sw.tik()
        st = _STAGES.setdefault(name, _StageStats())
        st.seconds += es
        st.bytes += nbytes
        st.calls += 1
        if log:
            if nbytes:
                olog(
                    "[%s] %s bytes in %s seconds (%s MBps).",
                    name,
                    comma_sep(nbytes),
                    comma_sep(es),
                    comma_sep(nbytes / max(es, 1e-12) / 1024.0 / 1024.0),
                )
            else:
                olog("[%s] done in %s seconds.", name, comma_sep(es))


def stage_report() -> dict[str, dict[str, float]]:
    """Accumulated per-stage seconds / bytes / MBps."""
    return {
        k: {
            "seconds": v.seconds,
            "bytes": v.bytes,
            "calls": v.calls,
            "MBps": v.bytes / max(v.seconds, 1e-12) / 1024.0 / 1024.0,
        }
        for k, v in _STAGES.items()
    }


def reset_stage_report() -> None:
    _STAGES.clear()


@contextlib.contextmanager
def trace_annotation(name: str):
    """JAX profiler annotation; no-op if profiling is unavailable.

    Only the annotation *setup* is guarded: exceptions raised by the
    annotated body must propagate untouched (a guard spanning the yield
    would catch them and yield again, turning every stage error into
    contextlib's opaque "generator didn't stop after throw()").
    """
    try:
        import jax.profiler as _prof

        cm = _prof.TraceAnnotation(name)
        cm.__enter__()
    except Exception:
        cm = None
    try:
        yield
    finally:
        if cm is not None:
            try:
                cm.__exit__(None, None, None)
            except Exception:
                pass  # profiler teardown must never mask the body's result


def device_profile(trace_dir: str):
    """Context manager writing a JAX device profile (TensorBoard trace) to
    ``trace_dir``; a no-op when ``trace_dir`` is empty.  Device-level
    observability on top of the per-stage MB/s report (the reference only
    has the latter, SURVEY §5 tracing)."""
    if not trace_dir:
        return contextlib.nullcontext()
    import jax

    olog("Profiling device execution to %s", trace_dir)
    return jax.profiler.trace(trace_dir)
