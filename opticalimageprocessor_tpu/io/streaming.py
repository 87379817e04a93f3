"""Double-buffered host->device section streaming.

The reference never holds less than the whole strip in RAM (LoadRawImage,
imageop.h:110-127) and streams only its remap through 30000-row sections.
For multi-GB scenes the device pipeline must instead keep HBM bounded and
overlap host I/O + H2D transfer with device compute (SURVEY §7:
"double-buffer and overlap DMA with compute").

:class:`SectionStreamer` iterates line sections of a memory-mapped RAW strip
with halo rows, prefetching the next section onto the device (JAX transfers
are asynchronous, so `jax.device_put` of section i+1 overlaps the device
compute on section i) while the previous result is drained to the host
writer thread-free via the same async queue.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from dataclasses import dataclass

import jax
import numpy as np

from .raw import RawStrip


@dataclass
class Section:
    index: int
    line_offset: int          # first payload line (excluding halo)
    lines: int                # payload lines
    halo_top: int             # halo rows actually present above the payload
    halo_bottom: int
    data: jax.Array           # (halo_top + lines + halo_bottom, W) on device


class SectionStreamer:
    """Iterate device-resident line sections of a RAW strip with halos.

    ``section_lines`` payload rows per step plus up to ``halo`` context rows
    on each side (clipped at the strip ends, like the cubic resample's
    border handling).  The next section's host read + H2D copy is issued
    before the current section is yielded, so device compute and transfer
    overlap (double buffering).
    """

    def __init__(
        self,
        strip: RawStrip,
        section_lines: int,
        halo: int = 0,
        device=None,
    ):
        self.strip = strip
        self.section_lines = section_lines
        self.halo = halo
        self.device = device or jax.devices()[0]

    def _load(self, idx: int) -> Section | None:
        off = idx * self.section_lines
        if off >= self.strip.lines:
            return None
        lines = min(self.section_lines, self.strip.lines - off)
        top = min(self.halo, off)
        bottom = min(self.halo, self.strip.lines - off - lines)
        block = self.strip.section(off - top, top + lines + bottom)
        data = jax.device_put(np.ascontiguousarray(block), self.device)
        return Section(idx, off, lines, top, bottom, data)

    def __iter__(self) -> Iterator[Section]:
        nxt = self._load(0)
        i = 0
        while nxt is not None:
            cur = nxt
            i += 1
            nxt = self._load(i)   # async H2D overlaps caller's compute
            yield cur

    def __len__(self) -> int:
        return -(-self.strip.lines // self.section_lines)


def stream_process(
    strip: RawStrip,
    fn: Callable[[Section], jax.Array],
    write: Callable[[np.ndarray], None],
    section_lines: int,
    halo: int = 0,
) -> int:
    """Run ``fn`` over every section and drain results to ``write``.

    ``fn`` receives a :class:`Section` (device array incl. halo rows) and
    must return the processed payload rows.  Device->host readback of
    section i-1 is deferred until section i's compute is enqueued, keeping
    transfer and compute overlapped in both directions.
    """
    pending: tuple[jax.Array, int] | None = None
    total = 0
    for sec in SectionStreamer(strip, section_lines, halo):
        out = fn(sec)
        if pending is not None:
            write(np.asarray(pending[0]))
            total += pending[1]
        pending = (out, sec.lines)
    if pending is not None:
        write(np.asarray(pending[0]))
        total += pending[1]
    return total
