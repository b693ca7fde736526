"""On-disk spill format for an E2LSHoS index (the paper's storage tier).

Byte for byte the reference's format, so a file spilled by either package
loads in the other:

    [0:8)    magic  b"E2LSHSPL"
    [8:12)   format version, uint32 LE (current: 1)
    [12:16)  header JSON length, uint32 LE
    [16:20)  header JSON crc32, uint32 LE
    [20:...) header JSON (utf-8), then zero padding to the first page boundary
    ...      sections, each starting on a page boundary

The header JSON records the section table (name -> offset/shape/dtype/crc32),
the layout metadata (``block_objs``, ``lane_pad``), and the solved
``LSHParams`` (and build ``IndexStats`` when available), so a spilled file
is self-describing: ``load_external`` rebuilds a queryable index from the
path alone. ``lane_pad`` comes from the header, so a file padded to 8 or to
128 lanes loads either way.

Sections:

* ``blocks`` — the bucket block store, interleaved ``[NB, 2, BLKp]`` int32
  (row g = ids row then fps row). This is the storage-resident section: one
  paper "block read" is one contiguous ``2 * BLKp * 4``-byte extent, which
  the mmap/aio/uring :class:`~repro_torch.storage.blockstore.BlockStore`
  backends fetch on demand. At SIFT1M it is ~16 GB, so the writer streams it
  from the device in row chunks, carrying the crc32 across chunks, and never
  holds it on the host whole.
* everything else (hash family ``a/b/rm``, hash tables ``blocks_head`` /
  ``table_off`` / ``table_cnt``, the CSR view ``entries_id`` / ``entries_fp``,
  and the DRAM tier ``db`` / ``db_norm2``) — resident sections, written in the
  reference's dtypes: ``rm`` uint32 and ``entries_fp`` uint16 (the port holds
  both as int32 on the device and converts at this boundary).
  ``load_external`` loads only the subset the external plan consumes.

Corruption policy: the magic/version/header crc are always verified;
per-section crc32s are verified for every section that is materialized. The
demand-paged ``blocks`` section is crc-checked only by ``load_arrays`` and
``verify_file``: checking it on ``load_external`` would read the whole store.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import zlib
from typing import Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

__all__ = ["StorageFormatError", "SpillHeader", "spill_index", "read_header",
           "load_arrays", "load_external", "verify_file", "aligned_extent",
           "spill_index_sharded", "read_manifest", "load_arrays_sharded",
           "load_external_sharded",
           "MAGIC", "FORMAT_VERSION", "PAGE_SIZE", "DIRECT_ALIGN_MIN",
           "MANIFEST_NAME", "MANIFEST_MAGIC", "MANIFEST_VERSION"]

MAGIC = b"E2LSHSPL"
FORMAT_VERSION = 1
PAGE_SIZE = 4096
# sharded spill directory (paper Sec. 7: one index, blocks striped over
# drives): MANIFEST.json + resident.e2l + one block-stripe file per shard
MANIFEST_NAME = "MANIFEST.json"
MANIFEST_MAGIC = "E2LSHSHD"
MANIFEST_VERSION = 1
# O_DIRECT read granularity floor. Every section starts on a PAGE_SIZE
# boundary and the file is truncated to a page boundary, so for any block
# row the aligned covering extent at any alignment <= PAGE_SIZE lies inside
# the file. Row strides (2 * blkp * 4 bytes) are not device-aligned; direct
# readers read the covering extent (`aligned_extent`).
DIRECT_ALIGN_MIN = 512

# resident IndexArrays leaves spilled as standalone sections (the block
# store spills as the interleaved "blocks" section instead)
_RESIDENT_FIELDS = ("a", "b", "rm", "blocks_head", "table_off", "table_cnt",
                    "entries_id", "entries_fp", "db", "db_norm2")
# ...of which plan="external" consumes these; load_external loads only them
_EXTERNAL_FIELDS = ("a", "b", "rm", "blocks_head", "table_cnt",
                    "db", "db_norm2")
# host buffer of the streamed blocks section
_CHUNK_BYTES = 256 << 20


class StorageFormatError(RuntimeError):
    """A spilled index file is unreadable: wrong magic, unsupported format
    version, or failed checksum."""


@dataclasses.dataclass(frozen=True)
class SpillHeader:
    """Parsed and verified file header."""

    version: int
    page_size: int
    block_objs: int
    lane_pad: int
    blkp: int                 # padded block-row width (columns per row)
    nb: int                   # block rows (incl. the spare row 0)
    sections: dict            # name -> {offset, shape, dtype, crc32, nbytes}
    params: Optional[dict]    # LSHParams asdict (radii as list) or None
    stats: Optional[dict]     # IndexStats asdict or None

    @property
    def blocks_offset(self) -> int:
        return int(self.sections["blocks"]["offset"])

    @property
    def block_row_bytes(self) -> int:
        """One block read's extent: ids row + fps row, int32."""
        return 2 * self.blkp * 4


def _page_pad(n: int, page_size: int) -> int:
    return -(-n // page_size) * page_size


def aligned_extent(offset: int, nbytes: int, align: int = DIRECT_ALIGN_MIN):
    """The aligned covering extent of ``[offset, offset + nbytes)``:
    ``(astart, alen, inner)`` with ``astart % align == 0``,
    ``alen % align == 0`` and the payload at ``[inner, inner + nbytes)`` of
    the landing buffer — the read shape O_DIRECT requires."""
    astart = (int(offset) // align) * align
    alen = -(-(int(offset) + int(nbytes) - astart) // align) * align
    return astart, alen, int(offset) - astart


def _crc(arr) -> int:
    return int(zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF)


class _BlockStream:
    """The interleaved ``[rows, 2, BLKp]`` int32 block store (rows
    ``start::step`` of the index's ``NB``), produced in row chunks from the
    index's device through one host buffer."""

    def __init__(self, arrays, start: int = 0, step: int = 1):
        ids_b, fps_b = arrays.ids_blocks, arrays.fps_blocks
        if ids_b.shape != fps_b.shape or ids_b.dim() != 2:
            raise ValueError(f"malformed block store: {tuple(ids_b.shape)} vs "
                             f"{tuple(fps_b.shape)}")
        self._ids, self._fps = ids_b[start::step], fps_b[start::step]
        rows, blkp = self._ids.shape
        self.shape = (int(rows), 2, int(blkp))
        self.dtype = np.dtype(np.int32)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * 4
        self.crc32 = None      # known once a pass has run

    def chunks(self):
        rows, _, blkp = self.shape
        per = max(1, _CHUNK_BYTES // (2 * blkp * 4))
        dev = self._ids.device
        host = torch.empty((min(per, max(rows, 1)), 2, blkp), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        crc = 0
        for s in range(0, rows, per):
            m = min(per, rows - s)
            host[:m].copy_(torch.stack([self._ids[s:s + m], self._fps[s:s + m]], dim=1))
            chunk = host[:m].numpy()
            crc = zlib.crc32(chunk, crc)
            yield chunk
        self.crc32 = int(crc & 0xFFFFFFFF)

    def compute_crc(self) -> int:
        for _ in self.chunks():
            pass
        return self.crc32


def spill_index(path, arrays, *, params=None, stats=None,
                page_size: int = PAGE_SIZE) -> SpillHeader:
    """Write ``arrays`` (an ``IndexArrays``, on any device) to ``path`` in the
    spill format. ``params`` (``LSHParams``) makes the file servable by
    ``load_external``; ``E2LSHIndex.spill`` passes it."""
    blocks = _BlockStream(arrays)
    payload = {"blocks": blocks}
    for name in _RESIDENT_FIELDS:
        payload[name] = np.ascontiguousarray(arrays.leaf_numpy(name))
    return _write_spill(
        path, payload, block_objs=int(arrays.block_objs),
        lane_pad=int(arrays.lane_pad), blkp=blocks.shape[2], nb=blocks.shape[0],
        params=params, stats=stats, page_size=page_size)


def _write_spill(path, payload: dict, *, block_objs: int, lane_pad: int,
                 blkp: int, nb: int, params=None, stats=None,
                 page_size: int = PAGE_SIZE) -> SpillHeader:
    """The one spill-file writer: magic + versioned crc-guarded header +
    page-aligned crc'd sections, laid out exactly as the reference lays them
    out. A payload value is a numpy array or a ``_BlockStream``.

    The header holds every section's crc32, and its length (crc digits
    included) sets the first section's offset. A stream's crc is known only
    after it has been read, so the layout is computed with the stream's crc
    at both extremes: where both give the same offsets (any header not
    within a few bytes of a page boundary), the file is written in one pass,
    the header last; otherwise a first pass computes the crc."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def header_json(sections: dict) -> bytes:
        meta = dict(
            page_size=page_size,
            block_objs=int(block_objs),
            lane_pad=int(lane_pad),
            blkp=int(blkp),
            nb=int(nb),
            sections=sections,
            params=_params_dict(params),
            stats=dict(stats.__dict__) if stats is not None else None,
        )
        return json.dumps(meta, sort_keys=True).encode("utf-8")

    def layout(crcs: dict) -> dict:
        def section_table(base: int) -> dict:
            table = {}
            off = base
            for name, arr in payload.items():
                table[name] = dict(offset=off, shape=[int(s) for s in arr.shape],
                                   dtype=str(arr.dtype), nbytes=int(arr.nbytes),
                                   crc32=crcs[name])
                off = _page_pad(off + arr.nbytes, page_size)
            return table

        base = _page_pad(20 + len(header_json(section_table(0))), page_size)
        # a second pass can only grow the JSON by the offset digits; re-pad once
        base2 = _page_pad(20 + len(header_json(section_table(base))), page_size)
        return section_table(max(base, base2))

    def offsets(sections: dict) -> dict:
        return {name: sec["offset"] for name, sec in sections.items()}

    streams = [n for n, v in payload.items() if isinstance(v, _BlockStream)]
    crcs = {n: _crc(v) for n, v in payload.items() if n not in streams}
    lo = layout({**crcs, **{n: 0 for n in streams}})
    hi = layout({**crcs, **{n: 0xFFFFFFFF for n in streams}})
    if offsets(lo) != offsets(hi):
        lo = layout({**crcs, **{n: payload[n].compute_crc() for n in streams}})
    with open(path, "wb") as f:
        for name, arr in payload.items():
            f.seek(lo[name]["offset"])
            if name in streams:
                for chunk in arr.chunks():
                    f.write(chunk)
            else:
                f.write(arr)
        end = lo[name]["offset"] + payload[name].nbytes
        f.truncate(_page_pad(end, page_size))
        sections = layout({**crcs, **{n: payload[n].crc32 for n in streams}})
        assert offsets(sections) == offsets(lo), "spill layout moved"
        hdr = header_json(sections)
        first = min(sec["offset"] for sec in sections.values())
        assert 20 + len(hdr) <= first, "spill header overflowed its page budget"
        f.seek(0)
        f.write(MAGIC)
        f.write(np.uint32(FORMAT_VERSION).tobytes())
        f.write(np.uint32(len(hdr)).tobytes())
        f.write(np.uint32(zlib.crc32(hdr) & 0xFFFFFFFF).tobytes())
        f.write(hdr)
    return read_header(path)


def _params_dict(params) -> Optional[dict]:
    if params is None:
        return None
    d = dict(dataclasses.asdict(params))
    d["radii"] = list(d["radii"])
    return d


def read_header(path) -> SpillHeader:
    """Parse and verify the file header (magic, version, crc)."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise StorageFormatError(
                f"{path}: not a spilled E2LSHoS index (magic {magic!r}, "
                f"expected {MAGIC!r})")
        version = int(np.frombuffer(f.read(4), np.uint32)[0])
        if version != FORMAT_VERSION:
            raise StorageFormatError(
                f"{path}: unsupported spill format version {version} "
                f"(this build reads version {FORMAT_VERSION}; re-spill the "
                "index with IndexArrays.spill)")
        hlen = int(np.frombuffer(f.read(4), np.uint32)[0])
        hcrc = int(np.frombuffer(f.read(4), np.uint32)[0])
        hdr = f.read(hlen)
    if len(hdr) != hlen or (zlib.crc32(hdr) & 0xFFFFFFFF) != hcrc:
        raise StorageFormatError(
            f"{path}: corrupted header (crc mismatch) — the file is "
            "truncated or damaged; re-spill the index")
    meta = json.loads(hdr.decode("utf-8"))
    return SpillHeader(
        version=version, page_size=int(meta["page_size"]),
        block_objs=int(meta["block_objs"]), lane_pad=int(meta["lane_pad"]),
        blkp=int(meta["blkp"]), nb=int(meta["nb"]),
        sections=meta["sections"], params=meta.get("params"),
        stats=meta.get("stats"),
    )


def _read_section(path, hdr: SpillHeader, name: str, *,
                  verify: bool = True) -> np.ndarray:
    sec = hdr.sections[name]
    arr = np.fromfile(path, dtype=np.dtype(sec["dtype"]),
                      count=int(np.prod(sec["shape"], dtype=np.int64)),
                      offset=int(sec["offset"]))
    if arr.nbytes != sec["nbytes"]:
        raise StorageFormatError(
            f"{path}: section {name!r} truncated "
            f"({arr.nbytes} of {sec['nbytes']} bytes)")
    if verify and _crc(arr) != sec["crc32"]:
        raise StorageFormatError(
            f"{path}: section {name!r} failed its crc32 check — the file "
            "is damaged; re-spill the index")
    return arr.reshape(sec["shape"])


def verify_file(path) -> SpillHeader:
    """Full integrity pass: header + every section crc (blocks included)."""
    hdr = read_header(path)
    for name in hdr.sections:
        _read_section(path, hdr, name, verify=True)
    return hdr


def _params_from(hdr: SpillHeader, path):
    from ..core.probabilities import LSHParams

    if hdr.params is None:
        raise StorageFormatError(
            f"{path}: spilled without LSHParams — serve it by spilling via "
            "E2LSHIndex.spill (or IndexArrays.spill(..., params=...))")
    pdict = dict(hdr.params)
    pdict["radii"] = tuple(pdict["radii"])
    return LSHParams(**pdict)


def _stats_from(hdr: SpillHeader):
    from ..core.index import IndexStats

    return None if hdr.stats is None else IndexStats(**hdr.stats)


def _resident_tensors(path, hdr: SpillHeader, dev: torch.device) -> dict:
    """The external plan's resident sections as tensors on ``dev`` (the
    uint32 multipliers as int32 bit patterns, as the port holds them)."""
    out = {}
    for name in _EXTERNAL_FIELDS:
        arr = _read_section(path, hdr, name)
        if name == "rm":
            arr = arr.astype(np.uint32).view(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return out


def load_arrays(path, *, device=None):
    """Materialize the full ``IndexArrays`` from a spilled file on ``device``
    (None -> cuda), every leaf crc-verified — the round-trip counterpart of
    ``IndexArrays.spill``."""
    from ..core.index import IndexArrays

    dev = resolve_device(device)
    hdr = read_header(path)
    blocks = _read_section(path, hdr, "blocks")
    leaves = {name: _read_section(path, hdr, name) for name in _RESIDENT_FIELDS}
    leaves.update(ids_blocks=blocks[:, 0], fps_blocks=blocks[:, 1])
    return IndexArrays.from_numpy(leaves, block_objs=hdr.block_objs,
                                  lane_pad=hdr.lane_pad, device=dev)


def load_external(path, *, backend: str = "aio", qd: int = 16,
                  cache_rows: Optional[int] = None, direct: bool = True,
                  strict: bool = False, prefetch_depth: int = 1, device=None):
    """Open a spilled index for external-memory querying on ``device``
    (None -> cuda).

    Hash tables, family params and the DRAM tier load onto the device; the
    block store stays on disk behind the selected
    :class:`~repro_torch.storage.blockstore.BlockStore` backend (``mem`` —
    the in-memory parity oracle; ``mmap`` — synchronous QD1 page-cache
    reads; ``aio`` — ``qd``-way pread fan-out with a clock page cache of
    ``cache_rows`` block rows; ``uring`` — io_uring wave submission with
    O_DIRECT demand reads where supported, falling back to ``aio`` unless
    ``strict``). ``direct=False`` keeps uring on buffered reads;
    ``prefetch_depth`` is how many chain steps of the next rung the
    external plan pushes into the store's queue under device compute.
    Returns an :class:`~repro_torch.storage.external.ExternalIndex` that
    ``SearchEngine`` serves under ``plan="external"``.
    """
    from .blockstore import make_store
    from .external import ExternalIndex

    dev = resolve_device(device)
    hdr = read_header(path)
    params = _params_from(hdr, path)
    resident = _resident_tensors(path, hdr, dev)
    store = make_store(backend, path, hdr, qd=qd, cache_rows=cache_rows,
                       direct=direct, strict=strict)
    return ExternalIndex(
        params=params, **resident,
        block_objs=hdr.block_objs, lane_pad=hdr.lane_pad, blkp=hdr.blkp,
        store=store, path=str(path), stats=_stats_from(hdr),
        prefetch_depth=int(prefetch_depth),
    )


# --------------------------------------------------------------------------
# Sharded spill: ONE global index, block store striped over per-shard files
# (the paper's multi-drive layout, Sec. 7 / Fig. 15 — hash tables resident,
# blocks distributed over drives). Stripe policy: round-robin by block row,
# global row g lives in shard g % num_shards at local row g // num_shards.
# --------------------------------------------------------------------------

def spill_index_sharded(path, arrays, num_shards: int, *, params=None,
                        stats=None, page_size: int = PAGE_SIZE) -> dict:
    """Write ``arrays`` as a sharded spill DIRECTORY at ``path``:

    * ``resident.e2l`` — every resident section (hash family, tables, CSR
      view, DRAM tier) in the spill-file format, no block store;
    * ``shard-NNN.e2l`` — one spill-file per shard holding that shard's
      round-robin block stripe as its ``blocks`` section;
    * ``MANIFEST.json`` — versioned, crc-guarded manifest tying them
      together (stripe policy, global row count, per-shard file table).

    Every file keeps the single-file format's guarantees, so shard files
    serve any ``BlockStore`` backend unchanged. Returns the manifest payload.
    """
    path = pathlib.Path(path)
    sh = int(num_shards)
    if sh < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    nb, blkp = (int(s) for s in arrays.ids_blocks.shape)
    if sh > nb:
        raise ValueError(
            f"cannot stripe {nb} block rows over {sh} shards (at most one "
            "shard per block row)")
    path.mkdir(parents=True, exist_ok=True)
    resident = {name: np.ascontiguousarray(arrays.leaf_numpy(name))
                for name in _RESIDENT_FIELDS}
    common = dict(block_objs=int(arrays.block_objs),
                  lane_pad=int(arrays.lane_pad), blkp=blkp, page_size=page_size)
    _write_spill(path / "resident.e2l", resident, nb=nb, params=params,
                 stats=stats, **common)
    shards = []
    for s in range(sh):
        stripe = _BlockStream(arrays, start=s, step=sh)
        fname = f"shard-{s:03d}.e2l"
        _write_spill(path / fname, {"blocks": stripe}, nb=stripe.shape[0], **common)
        shards.append(dict(file=fname, nb=stripe.shape[0]))
    payload = dict(
        num_shards=sh,
        stripe=dict(policy="round_robin", chunk_rows=1),
        nb_global=nb, blkp=blkp,
        block_objs=int(arrays.block_objs), lane_pad=int(arrays.lane_pad),
        resident="resident.e2l", shards=shards,
    )
    body = json.dumps(payload, sort_keys=True).encode("utf-8")
    manifest = dict(magic=MANIFEST_MAGIC, version=MANIFEST_VERSION,
                    crc32=int(zlib.crc32(body) & 0xFFFFFFFF), payload=payload)
    (path / MANIFEST_NAME).write_text(
        json.dumps(manifest, sort_keys=True, indent=1))
    return payload


def read_manifest(path) -> dict:
    """Parse and verify a sharded spill's ``MANIFEST.json`` (magic, version,
    payload crc); returns the manifest payload. ``path`` is the spill
    directory (or the manifest file itself)."""
    path = pathlib.Path(path)
    man_path = path / MANIFEST_NAME if path.is_dir() else path
    try:
        man = json.loads(man_path.read_text())
    except FileNotFoundError:
        raise StorageFormatError(
            f"{path}: not a sharded spill (no {MANIFEST_NAME}; single-file "
            "spills open with load_external)") from None
    except (OSError, json.JSONDecodeError) as e:
        raise StorageFormatError(
            f"{man_path}: unreadable sharded-spill manifest ({e})") from None
    if man.get("magic") != MANIFEST_MAGIC:
        raise StorageFormatError(
            f"{man_path}: not a sharded spill manifest "
            f"(magic {man.get('magic')!r}, expected {MANIFEST_MAGIC!r})")
    if int(man.get("version", -1)) != MANIFEST_VERSION:
        raise StorageFormatError(
            f"{man_path}: unsupported manifest version {man.get('version')} "
            f"(this build reads version {MANIFEST_VERSION}; re-spill the "
            "index with spill_index_sharded)")
    payload = man.get("payload")
    body = json.dumps(payload, sort_keys=True).encode("utf-8")
    if (zlib.crc32(body) & 0xFFFFFFFF) != int(man.get("crc32", -1)):
        raise StorageFormatError(
            f"{man_path}: corrupted manifest (crc mismatch) — the manifest "
            "was edited or damaged; re-spill the index")
    return payload


def _shard_headers(path: pathlib.Path, man: dict) -> list:
    """Open and cross-check every shard file against the manifest."""
    headers = []
    for s, entry in enumerate(man["shards"]):
        sp = path / entry["file"]
        try:
            shdr = read_header(sp)
        except FileNotFoundError:
            raise StorageFormatError(
                f"{path}: shard file {entry['file']!r} is missing — the "
                "sharded spill is incomplete; re-spill the index") from None
        if shdr.nb != int(entry["nb"]) or shdr.blkp != int(man["blkp"]):
            raise StorageFormatError(
                f"{sp}: shard {s} disagrees with the manifest "
                f"(nb {shdr.nb} vs {entry['nb']}, blkp {shdr.blkp} vs "
                f"{man['blkp']}) — mixed spill generations; re-spill")
        headers.append(shdr)
    return headers


def load_arrays_sharded(path, *, device=None):
    """Materialize the full ``IndexArrays`` from a sharded spill directory on
    ``device`` (None -> cuda), every section crc-verified and the stripes
    re-interleaved."""
    from ..core.index import IndexArrays

    dev = resolve_device(device)
    path = pathlib.Path(path)
    man = read_manifest(path)
    rhdr = read_header(path / man["resident"])
    leaves = {name: _read_section(path / man["resident"], rhdr, name)
              for name in _RESIDENT_FIELDS}
    sh = int(man["num_shards"])
    blocks = np.empty((int(man["nb_global"]), 2, int(man["blkp"])), dtype=np.int32)
    for s, shdr in enumerate(_shard_headers(path, man)):
        blocks[s::sh] = _read_section(path / man["shards"][s]["file"], shdr, "blocks")
    leaves.update(ids_blocks=blocks[:, 0], fps_blocks=blocks[:, 1])
    return IndexArrays.from_numpy(leaves, block_objs=rhdr.block_objs,
                                  lane_pad=rhdr.lane_pad, device=dev)


def load_external_sharded(path, *, backend: str = "aio", qd: int = 16,
                          cache_rows: Optional[int] = None,
                          direct: bool = True, strict: bool = False,
                          prefetch_depth: int = 1, device=None):
    """Open a sharded spill directory for external-memory querying under
    ``plan="sharded_external"`` on ``device`` (None -> cuda).

    Resident sections load from ``resident.e2l``; each shard's block stripe
    stays on disk behind its own block store (same ``backend``/``qd``/
    ``direct``/``strict`` semantics as ``load_external``), striped back
    together by a :class:`~repro_torch.storage.sharded.StripedBlockStore`.
    ``cache_rows`` is the total cache budget, divided evenly over shards.
    Returns a :class:`~repro_torch.storage.sharded.ShardedExternalIndex`.
    """
    from .blockstore import make_store
    from .sharded import ShardedExternalIndex, StripedBlockStore

    dev = resolve_device(device)
    path = pathlib.Path(path)
    man = read_manifest(path)
    rhdr = read_header(path / man["resident"])
    params = _params_from(rhdr, path)
    resident = _resident_tensors(path / man["resident"], rhdr, dev)
    sh = int(man["num_shards"])
    per_cache = (None if cache_rows is None
                 else max(1, -(-int(cache_rows) // sh)))
    stores = []
    try:
        for s, shdr in enumerate(_shard_headers(path, man)):
            stores.append(make_store(
                backend, path / man["shards"][s]["file"], shdr, qd=qd,
                cache_rows=per_cache, direct=direct, strict=strict))
    except Exception:
        for st in stores:
            st.close()
        raise
    store = StripedBlockStore(stores, nb=int(man["nb_global"]),
                              blkp=int(man["blkp"]))
    return ShardedExternalIndex(
        params=params, **resident,
        block_objs=rhdr.block_objs, lane_pad=rhdr.lane_pad, blkp=rhdr.blkp,
        store=store, path=str(path), stats=_stats_from(rhdr),
        prefetch_depth=int(prefetch_depth),
        num_shards=sh, manifest=man,
    )
