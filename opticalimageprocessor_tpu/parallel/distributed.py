"""Multi-host launch path: env-driven ``jax.distributed`` setup.

SURVEY §5's distributed-communication row covers two transports:
collectives inside a jitted step (``sharded.py`` / ``sharded_scene.py``)
and the cross-process control plane that makes one logical mesh span
several processes.  This module is the latter — the equivalent of the
reference's would-be MPI launcher: each process calls
:func:`maybe_initialize_distributed` before first backend use, after
which ``jax.devices()`` is the GLOBAL device list, the existing
``line_mesh()`` spans processes, and the per-shard ingest callbacks
(``sharded.ingest_line_sharded``) are invoked only for each process's
addressable shards — per-process shard IO with zero code changes.

Launch (one process per host, or one per GPU)::

    OIP_DIST_COORD=localhost:9876 OIP_DIST_NPROCS=4 OIP_DIST_PROCID=k \\
        oiptpu scene --mesh 4 ...

Collectives go over NVLink between a host's GPUs (NCCL) and over the
network across hosts; XLA partitions them from the same ``shard_map``
programs.
"""

from __future__ import annotations

import os

_ENV_COORD = "OIP_DIST_COORD"
_ENV_NPROCS = "OIP_DIST_NPROCS"
_ENV_PROCID = "OIP_DIST_PROCID"
_ENV_LOCAL_IDS = "OIP_DIST_LOCAL_DEVICE_IDS"

_initialized = False


def distributed_env_present() -> bool:
    """True iff the launch env requests multi-process operation."""
    return bool(os.environ.get(_ENV_COORD))


def maybe_initialize_distributed() -> bool:
    """Initialise ``jax.distributed`` from ``OIP_DIST_*`` env vars.

    Must run before the first jax backend use in the process.  No-op
    (returns False) when ``OIP_DIST_COORD`` is unset, so single-process
    runs pay nothing.  Idempotent within a process.

    Env contract:
      - ``OIP_DIST_COORD``  — ``host:port`` of process 0's coordinator
      - ``OIP_DIST_NPROCS`` — total number of processes
      - ``OIP_DIST_PROCID`` — this process's id in ``[0, NPROCS)``
      - ``OIP_DIST_LOCAL_DEVICE_IDS`` — optional comma-separated local
        device ids to claim (defaults to all local devices)
    """
    global _initialized
    if not distributed_env_present():
        return False
    if _initialized:
        return True

    import jax

    try:
        nprocs = int(os.environ[_ENV_NPROCS])
        procid = int(os.environ[_ENV_PROCID])
    except KeyError as e:
        raise RuntimeError(
            f"{_ENV_COORD} is set but {e.args[0]} is missing: the "
            "distributed launch env needs all of "
            f"{_ENV_COORD}/{_ENV_NPROCS}/{_ENV_PROCID}"
        ) from None
    if not (0 <= procid < nprocs):
        raise RuntimeError(
            f"{_ENV_PROCID}={procid} outside [0, {_ENV_NPROCS}={nprocs})"
        )
    kwargs = {}
    ids = os.environ.get(_ENV_LOCAL_IDS)
    if ids:
        kwargs["local_device_ids"] = [int(x) for x in ids.split(",")]
    jax.distributed.initialize(
        coordinator_address=os.environ[_ENV_COORD],
        num_processes=nprocs,
        process_id=procid,
        **kwargs,
    )
    _initialized = True
    return True


def process_index() -> int:
    import jax

    return jax.process_index()


def is_primary() -> bool:
    """True on the process that should perform host-side singleton work
    (writing output files, OLOG QA tables)."""
    import jax

    return jax.process_index() == 0


def drain_line_sharded_to_raw(
    arr,
    path: str,
    pixels_per_line: int,
    total: int | None = None,
) -> str:
    """Multi-host drain of a line-sharded uint16 array to ONE RAW file.

    Each process writes only its addressable shards, at their global row
    offsets, into a shared (network) filesystem file that process 0
    pre-sizes; device-collective barriers order create -> write ->
    return.  This is the DCN-era counterpart of the sequential
    shard-by-shard drain (host RSS stays bounded by one shard either
    way).  ``total`` trims mesh-padding rows at the strip bottom.

    Single-process callers get plain sequential writes (no barriers), so
    the helper is safe as the only drain implementation.
    """
    import jax
    import numpy as np

    if total is None:
        total = arr.shape[0]
    row_bytes = pixels_per_line * 2
    multi = jax.process_count() > 1
    if not multi or jax.process_index() == 0:
        with open(path, "wb") as f:
            f.truncate(total * row_bytes)
    if multi:
        barrier("drain-create:" + path)
    with open(path, "r+b") as f:
        for sh in sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start or 0
        ):
            a = sh.index[0].start or 0
            b = sh.index[0].stop
            b = total if b is None else min(b, total)
            if a >= b:
                continue
            data = np.asarray(sh.data)[: b - a]
            f.seek(a * row_bytes)
            f.write(
                np.ascontiguousarray(data, dtype="<u2")
                .reshape(b - a, -1)[:, :pixels_per_line]
                .tobytes()
            )
    if multi:
        barrier("drain-done:" + path)
    return path


def drain_line_sharded_to_tiff(
    arr,
    path: str,
    total: int | None = None,
    order: list[int] | None = None,
    rows_per_strip: int = 512,
    photometric: int | None = None,
    extrasamples: int | None = None,
    row0: int = 0,
) -> str:
    """Multi-host drain of a line-sharded raster to ONE uncompressed
    strip TIFF.

    Process 0 creates the complete file shell (header + zero raster +
    IFD — :func:`io.tiff.create_tiff_shell`); after a barrier every
    process writes its addressable shards' rows at their computed byte
    offsets (uncompressed rows are affine in the row index).  ``order``
    optionally permutes the sample axis per block (the BGRA TIFF channel
    convention); ``row0``/``total`` select the array row range [row0,
    total) that becomes the raster (the leading-overlap trim).
    Single-process callers get the same flow without barriers.
    Compressed output needs the sequential single-process writer —
    variable strip sizes cannot be pre-assigned.
    """
    import jax
    import numpy as np

    from ..io.tiff import create_tiff_shell, tiff_data_start

    if total is None:
        total = arr.shape[0]
    height = total - row0
    width = arr.shape[1]
    samples = arr.shape[2] if arr.ndim == 3 else 1
    row_bytes = width * samples * 2
    multi = jax.process_count() > 1
    if not multi or jax.process_index() == 0:
        data_start = create_tiff_shell(
            path, width, height, samples,
            rows_per_strip=rows_per_strip, photometric=photometric,
            extrasamples=extrasamples,
        )
        # non-primaries project this offset without opening the shell —
        # the projection and the writer must agree byte-for-byte
        assert data_start == tiff_data_start(width, height, samples)
    else:
        # deterministic: the header is the only thing before the raster
        data_start = tiff_data_start(width, height, samples)
    if multi:
        barrier("tiff-create:" + path)
    with open(path, "r+b") as f:
        for sh in sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start or 0
        ):
            a = sh.index[0].start or 0
            b = sh.index[0].stop
            b = total if b is None else min(b, total)
            lo = max(a, row0)
            if lo >= b:
                continue
            block = np.asarray(sh.data)[lo - a : b - a]
            if order is not None:
                block = block[..., order]
            f.seek(data_start + (lo - row0) * row_bytes)
            f.write(np.ascontiguousarray(block, dtype="<u2").tobytes())
    if multi:
        barrier("tiff-done:" + path)
    return path


def _addressable_row_range(arr) -> tuple[int, int]:
    """Contiguous [lo, hi) array-row range of this process's addressable
    shards (a 1-D line mesh assigns each process one contiguous block of
    rows; assert rather than assume)."""
    spans = sorted(
        (sh.index[0].start or 0,
         sh.index[0].stop if sh.index[0].stop is not None else arr.shape[0])
        for sh in arr.addressable_shards
    )
    lo, hi = spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a != hi:
            raise ValueError(
                f"addressable shards not row-contiguous: gap at {hi}..{a}"
            )
        hi = b
    return lo, hi


def drain_line_sharded_to_tiff_lzw(
    arr,
    path: str,
    total: int | None = None,
    order: list[int] | None = None,
    rows_per_strip: int = 512,
    row0: int = 0,
    photometric: int | None = None,
    extrasamples: int | None = None,
    predictor: bool = True,
) -> str:
    """Multi-host drain of a line-sharded raster to ONE LZW(+predictor-2)
    strip TIFF — the compressed counterpart of
    :func:`drain_line_sharded_to_tiff` (reference ancestor: the GDAL
    LZW/PREDICTOR=2 BigTIFF writer, imageop.h:470-474, which serialises
    compression in one process).

    TIFF strips are independently compressed, so each process LZW-encodes
    the strips whose FIRST raster row it holds (io.tiff.encode_lzw_strip —
    identical bytes to the sequential writer) into a temp segment file;
    boundary strips straddling a process edge are completed with spill
    rows the next process(es) drop beside the output; then process 0
    stitches segments + strip tables into the final file
    (io.tiff.assemble_tiff_from_strips) — offsets are assignable once the
    compressed sizes are known.  Decodes identically to a sequential
    :class:`TiffStripWriter` run (and byte-identically when content
    doesn't trip the sequential writer's first-strip expansion fallback,
    which this drain intentionally omits: compression is file-global and
    satellite rasters compress).

    Single-process callers run the same flow without barriers or spills.
    """
    import jax
    import numpy as np

    from ..io.tiff import assemble_tiff_from_strips, encode_lzw_strip

    if total is None:
        total = arr.shape[0]
    height = total - row0
    width = arr.shape[1]
    samples = arr.shape[2] if arr.ndim == 3 else 1
    rps = rows_per_strip
    n_strips = -(-height // rps)
    multi = jax.process_count() > 1
    me = jax.process_index()
    nprocs = jax.process_count()

    lo, hi = _addressable_row_range(arr)
    lo_r, hi_r = max(lo, row0), min(hi, total)   # my rows in the raster
    mine = None
    if hi_r > lo_r:
        blocks = []
        for sh in sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start or 0
        ):
            a = sh.index[0].start or 0
            b = sh.index[0].stop
            b = arr.shape[0] if b is None else b
            s, e = max(a, lo_r), min(b, hi_r)
            if s < e:
                blocks.append(np.asarray(sh.data)[s - a : e - a])
        mine = np.concatenate(blocks) if len(blocks) > 1 else blocks[0]
        # same coercion as the sibling drains: little-endian uint16 is
        # what encode_lzw_strip/assemble_tiff_from_strips' uint16 IFD
        # promises (a float intermediate would otherwise compress raw
        # float bytes under a BITSPERSAMPLE=16 header)
        mine = np.ascontiguousarray(mine, dtype="<u2")
        if mine.ndim == 2:
            mine = mine[:, :, None]
        if order is not None:
            mine = mine[:, :, order]

    # strip k covers raster rows [k*rps, min((k+1)*rps, height)), i.e.
    # array rows [row0 + k*rps, ...); owner = holder of the first row
    def strip_of(array_row: int) -> int:
        return (array_row - row0) // rps

    if multi:
        # spill: my leading rows that belong to a strip starting before my
        # range (the strip's owner needs them to complete its last strips)
        np.save(f"{path}.rng.{me}.npy", np.asarray([lo_r, hi_r]))
        spill_rows = 0
        if mine is not None and lo_r > row0 and (lo_r - row0) % rps:
            strip_end = row0 + (strip_of(lo_r) + 1) * rps
            spill_rows = min(strip_end, hi_r) - lo_r
        np.save(
            f"{path}.spill.{me}.npy",
            mine[:spill_rows] if mine is not None
            else np.zeros((0, width, samples), np.uint16),
        )
        barrier("lzw-spill:" + path)
        ranges = [
            np.load(f"{path}.rng.{p}.npy") for p in range(nprocs)
        ]
        # segments are concatenated in process order at assembly, so the
        # process->row placement must be ascending — assert rather than
        # assume (a permuted mesh would otherwise produce a decodable
        # TIFF with its row blocks swapped, silently)
        prev_hi = None
        for p in range(nprocs):
            plo, phi = int(ranges[p][0]), int(ranges[p][1])
            if phi <= plo:
                continue
            if prev_hi is not None and plo < prev_hi:
                raise ValueError(
                    "line-sharded processes are not in ascending raster-"
                    f"row order (process {p} starts at row {plo}, before "
                    f"a previous process's end {prev_hi}); the LZW drain "
                    "requires process index order == row order"
                )
            prev_hi = phi
    else:
        spill_rows = 0
        ranges = [np.asarray([lo_r, hi_r])]

    # my strips: first raster row in [lo_r, hi_r) and on my side of the
    # first strip boundary at/after lo_r
    k0 = strip_of(lo_r) if mine is not None else n_strips
    if mine is not None and (lo_r - row0) % rps:
        k0 += 1          # head strip belongs to the previous process
    k1 = strip_of(hi_r - 1) + 1 if mine is not None and hi_r > lo_r else k0
    k1 = min(k1, n_strips)

    counts = []
    with open(f"{path}.seg.{me}" if multi else f"{path}.seg.0", "wb") as seg:
        spill_cache: dict[int, np.ndarray] = {}
        for k in range(k0, k1):
            a = row0 + k * rps
            b = min(a + rps, total)
            s, e = max(a, lo_r), min(b, hi_r)
            parts = [mine[s - lo_r : e - lo_r]]
            nxt = e
            p = me + 1
            while nxt < b and p < nprocs:
                # complete a straddling strip with the next process's spill
                plo, phi = int(ranges[p][0]), int(ranges[p][1])
                if phi <= plo:       # process holds no raster rows
                    p += 1
                    continue
                if p not in spill_cache:
                    spill_cache[p] = np.load(f"{path}.spill.{p}.npy")
                take = spill_cache[p][: min(b, phi) - plo]
                if nxt != plo:
                    raise ValueError(
                        f"strip {k}: expected spill at row {nxt}, "
                        f"process {p} starts at {plo}"
                    )
                parts.append(take)
                nxt = plo + take.shape[0]
                p += 1
            strip = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if strip.shape[0] != b - a:
                raise ValueError(
                    f"strip {k}: assembled {strip.shape[0]} rows, "
                    f"want {b - a}"
                )
            blob = encode_lzw_strip(strip, predictor=predictor)
            counts.append(len(blob))
            seg.write(blob)
    np.save(f"{path}.cnt.{me}.npy", np.asarray(counts, np.int64))
    if multi:
        barrier("lzw-seg:" + path)

    if not multi or me == 0:
        def blobs():
            for p in range(nprocs):
                cnt = np.load(f"{path}.cnt.{p}.npy")
                with open(f"{path}.seg.{p}", "rb") as f:
                    for c in cnt:
                        yield f.read(int(c))

        assemble_tiff_from_strips(
            path, width, height, samples, blobs(),
            rows_per_strip=rps, predictor=predictor,
            photometric=photometric, extrasamples=extrasamples,
        )
        for p in range(nprocs):
            for side in (f"{path}.seg.{p}", f"{path}.cnt.{p}.npy",
                         f"{path}.rng.{p}.npy", f"{path}.spill.{p}.npy"):
                if os.path.exists(side):
                    os.remove(side)
    if multi:
        barrier("lzw-done:" + path)
    return path


def require_single_process_drain(what: str) -> None:
    """Guard for sequential file drains that assume EVERY shard of a
    line-sharded array is addressable locally.  In a multi-process run
    each process holds only its own shards, so a sequential drain would
    silently write a partial raster — fail loudly instead until the
    offset-write multi-host drain lands."""
    import jax

    if jax.process_count() > 1:
        raise NotImplementedError(
            f"{what}: sequential file drain is single-process only; in a "
            f"multi-host run ({jax.process_count()} processes) each "
            "process holds only its addressable shards.  Multi-host "
            "output drains (per-host row-offset writes) are not "
            "implemented yet — run the drain stage single-process."
        )


def barrier(name: str = "oip_barrier") -> None:
    """Cross-process sync point (device-collective based: one tiny psum
    over every device, forcing all hosts to reach the same program
    point before any host proceeds)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("b",))
    one = jax.make_array_from_callback(
        (len(devs),),
        NamedSharding(mesh, P("b")),
        lambda idx: np.ones(1, np.float32),
    )
    out = jax.jit(
        jnp.sum, out_shardings=NamedSharding(mesh, P())
    )(one)
    got = int(out.block_until_ready()[()])
    if got != len(devs):
        raise RuntimeError(f"barrier '{name}': {got} != {len(devs)}")
