"""Real asynchronous block I/O: io_uring + O_DIRECT, bound via ctypes.

The ``aio`` backend *emulates* high queue depth with a ``pread`` thread
pool — useful as a portable discipline comparison, but every read still
goes through the page cache and a full syscall round-trip per block, so on
a cached spill it measures request handling, not the device. This module
is the paper's actual design (Sec. 5.2, Table 3): block reads are submitted
to the kernel as a *batch* through an io_uring submission queue — one
``io_uring_enter`` syscall per wave of ``qd`` reads — and the file is
opened ``O_DIRECT`` so demand reads bypass the page cache and hit the
device. No new dependency: the three io_uring
syscalls are raw ``libc.syscall`` calls and the shared rings are mapped
with ``mmap`` — the same binding surface liburing wraps.

Capability story: io_uring may be unavailable (old kernel, seccomp —
``ENOSYS``/``EPERM``) and ``O_DIRECT`` is per-filesystem (tmpfs refuses
it). :func:`capabilities` probes both at runtime;
:func:`~repro_torch.storage.blockstore.make_store` uses it to fall back
gracefully to the ``aio`` thread pool (same ``BlockStore`` contract, so
``plan="external"``, ``BatchQueue`` and the N_io tie-out are unaffected —
only the I/O discipline changes). A ``uring`` store without ``O_DIRECT``
support still batches submissions; it just reads through the cache.

O_DIRECT alignment: reads must be issued at the device's logical block
granularity (512 B or 4 KiB). Block rows are ``2 * blkp * 4`` bytes at
arbitrary multiples from a page-aligned section start
(``format.SpillHeader`` guarantees the section alignment), so each row
read covers the *aligned extent* containing it: start rounded down, length
rounded up, the row sliced out of the landing buffer. Landing buffers are
anonymous ``mmap`` slots (page-aligned by construction), one per ring
entry. The probe discovers the coarsest required alignment (512 then
4096) per file.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import struct
import tempfile
from typing import Optional

import numpy as np

__all__ = ["IoUring", "UringUnavailable", "capabilities", "probe_io_uring",
           "probe_o_direct", "UringBlockStore"]

# -- syscall numbers (x86_64 / aarch64 share them for io_uring) -------------
_SYS_IO_URING_SETUP = 425
_SYS_IO_URING_ENTER = 426

_IORING_OFF_SQ_RING = 0
_IORING_OFF_SQES = 0x10000000
_IORING_ENTER_GETEVENTS = 1
_IORING_OP_READ = 22
_IORING_FEAT_SINGLE_MMAP = 1

_O_DIRECT = getattr(os, "O_DIRECT", 0o40000)

_libc = ctypes.CDLL(None, use_errno=True)


class UringUnavailable(OSError):
    """io_uring (or a required capability) is not usable here; callers fall
    back to the ``aio`` thread-pool backend."""


class _SQOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "flags",
                 "dropped", "array", "resv1")] + [("user_addr",
                                                   ctypes.c_uint64)]


class _CQOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "overflow",
                 "cqes", "flags", "resv1")] + [("user_addr", ctypes.c_uint64)]


class _UringParams(ctypes.Structure):
    _fields_ = [("sq_entries", ctypes.c_uint32),
                ("cq_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("sq_thread_cpu", ctypes.c_uint32),
                ("sq_thread_idle", ctypes.c_uint32),
                ("features", ctypes.c_uint32),
                ("wq_fd", ctypes.c_uint32),
                ("resv", ctypes.c_uint32 * 3),
                ("sq_off", _SQOffsets),
                ("cq_off", _CQOffsets)]


# struct io_uring_sqe for IORING_OP_READ: opcode, flags, ioprio, fd, off,
# addr, len, rw_flags, user_data, buf_index, personality, splice_fd_in,
# 2x u64 pad — 64 bytes.
_SQE = struct.Struct("<BBHiQQIIQHHiQQ")
assert _SQE.size == 64
_CQE = struct.Struct("<QiI")           # user_data, res, flags — 16 bytes


class IoUring:
    """A minimal single-issuer io_uring: batch file reads, one syscall per
    wave. Not thread-safe — callers serialize (the uring BlockStore drives
    it from one submitter thread)."""

    def __init__(self, entries: int):
        entries = max(1, int(entries))
        # kernel wants a power of two; it rounds up anyway, but being exact
        # keeps sq_entries == what we sized the buffers for
        self.entries = 1 << (entries - 1).bit_length()
        p = _UringParams()
        fd = _libc.syscall(_SYS_IO_URING_SETUP, self.entries,
                           ctypes.byref(p))
        if fd < 0:
            err = ctypes.get_errno()
            raise UringUnavailable(
                err, f"io_uring_setup failed: {os.strerror(err)}")
        self.fd = fd
        self.entries = int(p.sq_entries)
        if not p.features & _IORING_FEAT_SINGLE_MMAP:
            # pre-5.4 kernels map SQ and CQ separately; every kernel with
            # usable read batching has single-mmap, so treat it as absent
            os.close(fd)
            raise UringUnavailable(0, "io_uring lacks IORING_FEAT_SINGLE_MMAP")
        sq_sz = p.sq_off.array + p.sq_entries * 4
        cq_sz = p.cq_off.cqes + p.cq_entries * _CQE.size
        try:
            self._ring_mm = mmap.mmap(
                fd, max(sq_sz, cq_sz), flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQ_RING)
            self._sqes_mm = mmap.mmap(
                fd, p.sq_entries * _SQE.size, flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQES)
        except OSError as e:
            os.close(fd)
            raise UringUnavailable(e.errno or 0,
                                   f"io_uring ring mmap failed: {e}")
        # uint32 view over the shared ring head/tail/array words
        self._ring = np.frombuffer(self._ring_mm, dtype=np.uint32)
        self._sq_head = p.sq_off.head // 4
        self._sq_tail = p.sq_off.tail // 4
        self._sq_mask = int(self._ring[p.sq_off.ring_mask // 4])
        self._sq_array = p.sq_off.array // 4
        self._cq_head = p.cq_off.head // 4
        self._cq_tail = p.cq_off.tail // 4
        self._cq_mask = int(self._ring[p.cq_off.ring_mask // 4])
        self._cq_cqes = p.cq_off.cqes

    def _enter(self, to_submit: int, min_complete: int) -> int:
        r = _libc.syscall(_SYS_IO_URING_ENTER, self.fd, to_submit,
                          min_complete, _IORING_ENTER_GETEVENTS, None, 0)
        if r < 0:
            err = ctypes.get_errno()
            if err == 4:                  # EINTR: retry the wait
                return self._enter(0, min_complete)
            raise OSError(err, f"io_uring_enter: {os.strerror(err)}")
        return r

    def read_batch(self, fd: int, reads) -> list:
        """Submit ``reads`` = [(offset, length, buf_addr), ...] (at most
        ``entries``) as one SQ batch + one enter syscall; block for all
        completions. Returns ``res`` per read, in submission order."""
        n = len(reads)
        assert n <= self.entries, (n, self.entries)
        ring, mask = self._ring, self._sq_mask
        tail = int(ring[self._sq_tail])
        for i, (off, length, addr) in enumerate(reads):
            idx = (tail + i) & mask
            self._sqes_mm[idx * 64:(idx + 1) * 64] = _SQE.pack(
                _IORING_OP_READ, 0, 0, fd, off, addr, length, 0,
                i, 0, 0, 0, 0, 0)
            ring[self._sq_array + idx] = idx
        ring[self._sq_tail] = np.uint32(tail + n)     # publish (x86/ARM TSO
        self._enter(n, n)                             # via the syscall fence)
        out = [None] * n
        head = int(ring[self._cq_head])
        got = 0
        while got < n:
            cq_tail = int(ring[self._cq_tail])
            while head != cq_tail:
                base = self._cq_cqes + (head & self._cq_mask) * _CQE.size
                user_data, res, _ = _CQE.unpack_from(self._ring_mm, base)
                out[int(user_data)] = int(res)
                head += 1
                got += 1
            ring[self._cq_head] = np.uint32(head)
            if got < n:                               # CQ lagged: wait more
                self._enter(0, n - got)
        return out

    def close(self) -> None:
        if getattr(self, "fd", -1) >= 0:
            self._ring = None
            self._ring_mm.close()
            self._sqes_mm.close()
            os.close(self.fd)
            self.fd = -1


# --------------------------------------------------------------------------
# Capability probe
# --------------------------------------------------------------------------

def probe_io_uring() -> tuple:
    """(usable, reason). Tries a real io_uring_setup — the only reliable
    probe under seccomp, which fails the syscall rather than the import."""
    try:
        ring = IoUring(4)
    except UringUnavailable as e:
        return False, str(e)
    ring.close()
    return True, "ok"


def probe_o_direct(path) -> tuple:
    """(alignment or 0, reason) for O_DIRECT reads of ``path``'s filesystem:
    the smallest working read alignment (512 or 4096), or 0 when the
    filesystem refuses O_DIRECT (e.g. tmpfs)."""
    path = os.fspath(path)
    probe_dir = path if os.path.isdir(path) else (os.path.dirname(path)
                                                  or ".")
    tmp = None
    try:
        if os.path.isfile(path):
            name = path
        else:
            tf = tempfile.NamedTemporaryFile(dir=probe_dir, delete=False)
            tf.write(b"\0" * 8192)
            tf.close()
            name = tmp = tf.name
        try:
            fd = os.open(name, os.O_RDONLY | _O_DIRECT)
        except OSError as e:
            return 0, f"O_DIRECT open refused: {e}"
        try:
            buf = mmap.mmap(-1, 8192)      # page-aligned landing buffer
            for align in (512, 4096):
                try:
                    if os.preadv(fd, [memoryview(buf)[:align]], 0) > 0:
                        return align, "ok"
                except OSError:
                    continue
            return 0, "O_DIRECT reads failed at 512/4096 alignment"
        finally:
            os.close(fd)
    finally:
        if tmp is not None:
            os.unlink(tmp)


def capabilities(path=None) -> dict:
    """Runtime async-I/O capability report (the gate in front of the
    ``uring`` backend and its lanes/tests).

    * ``io_uring``       — the syscalls work here (kernel + seccomp);
    * ``o_direct_align`` — smallest working O_DIRECT read alignment on
      ``path``'s filesystem (0 = unsupported; ``path`` defaults to the
      system temp dir, where scratch spills live);
    * ``uring_store``    — the ``uring`` BlockStore can run at all
      (io_uring present; O_DIRECT is optional — without it the store
      batches submissions but reads through the page cache).
    """
    ok, reason = probe_io_uring()
    align, d_reason = probe_o_direct(path if path is not None
                                     else tempfile.gettempdir())
    return dict(
        io_uring=ok, io_uring_reason=reason,
        o_direct_align=int(align), o_direct_reason=d_reason,
        uring_store=ok,
        kernel=os.uname().release,
    )


# --------------------------------------------------------------------------
# The uring BlockStore
# --------------------------------------------------------------------------

from .blockstore import CachedBlockStore  # noqa: E402  (cycle-free: base only)


class UringBlockStore(CachedBlockStore):
    """Block reads through io_uring at queue depth ``qd``, O_DIRECT when the
    filesystem allows it (the paper's Sec. 5.2 discipline, real).

    Same cache/ledger contract as the ``aio`` backend (one
    :class:`CachedBlockStore` base): batched cache resolution, misses to the
    device, advisory prefetch joined in flight. The device path differs:
    a miss batch becomes waves of up to ``qd`` reads, each wave ONE
    ``io_uring_enter`` syscall submitting every read and blocking until the
    wave completes — the kernel holds ``qd`` reads in flight against the
    device, which is what actually buys T_async = max(compute, storage)
    on real flash (Eq. 7). With O_DIRECT the reads bypass the page cache:
    demand latency is device latency, the cache-defeating measurement mode
    of docs/storage.md.

    The ring is driven from the store's single submitter thread (io_uring
    is single-issuer here); demand batches and prefetch batches serialize
    on it, each at full ring depth.
    """

    name = "uring"

    def __init__(self, path, offset: int, nb: int, blkp: int, *,
                 qd: int = 32, cache_rows: Optional[int] = None,
                 direct: bool = True):
        ok, reason = probe_io_uring()
        if not ok:
            raise UringUnavailable(0, reason)
        self._ring = IoUring(qd)
        self.qd = int(self._ring.entries)
        self._base = int(offset)
        self._stride = 2 * int(blkp) * 4
        # O_DIRECT per-file probe: refused (tmpfs) -> buffered fd, still
        # batched through the ring; callers read .o_direct for the mode
        align = 0
        if direct:
            align, _ = probe_o_direct(path)
        self.o_direct = bool(align)
        self.align = int(align) if align else 512
        flags = os.O_RDONLY | (_O_DIRECT if self.o_direct else 0)
        self._fd = os.open(os.fspath(path), flags)
        # one page-aligned landing slot per ring entry, each big enough for
        # a row's aligned covering extent
        self._slot_len = self._align_up(self._stride) + self.align
        self._buf = mmap.mmap(-1, self._slot_len * self.qd)
        self._buf_addr = ctypes.addressof(
            ctypes.c_char.from_buffer(self._buf))
        # single submitter thread: ring + landing buffers have one owner
        super().__init__(nb, blkp, qd=self.qd, cache_rows=cache_rows,
                         workers=1)

    def _align_up(self, n: int) -> int:
        return -(-n // self.align) * self.align

    # -- CachedBlockStore device hooks --------------------------------------
    def _device_chunks(self, rows: np.ndarray) -> list:
        return [rows]          # one chunk: the ring IS the fan-out

    def _read_chunk(self, rows) -> dict:
        from ..telemetry import get_tracer
        from .format import aligned_extent

        out = {}
        rows = np.asarray(rows, dtype=np.int64).ravel()
        stride, align = self._stride, self.align
        tracer = get_tracer()
        for wave_start in range(0, rows.size, self.qd):
            wave = rows[wave_start:wave_start + self.qd]
            reads, inner = [], []
            for i, g in enumerate(wave):
                astart, alen, off = aligned_extent(
                    self._base + int(g) * stride, stride, align)
                assert alen <= self._slot_len, (alen, self._slot_len)
                reads.append((astart, alen,
                              self._buf_addr + i * self._slot_len))
                inner.append(off)
            # one span per wave: submit -> complete of ONE io_uring_enter
            # (recorded on the submitter thread; the rung span that caused
            # it lives on the caller thread, so the wave is its own root)
            with tracer.span("uring.wave", n=len(reads), qd=self.qd,
                             o_direct=self.o_direct):
                res = self._ring.read_batch(self._fd, reads)
            for i, g in enumerate(wave):
                need = inner[i] + stride
                if res[i] < 0:
                    raise IOError(
                        f"io_uring read of block row {int(g)} failed: "
                        f"{os.strerror(-res[i])}")
                if res[i] < need:
                    raise IOError(f"short io_uring read at block row "
                                  f"{int(g)}: {res[i]} < {need}")
                lo = i * self._slot_len + inner[i]
                out[int(g)] = (np.frombuffer(self._buf, np.int32,
                                             count=stride // 4, offset=lo)
                               .reshape(2, self.blkp).copy())
        return out

    def close(self):
        super().close()        # drains the submitter thread first
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None
        if getattr(self, "_ring", None) is not None:
            # the mmap buffer is exported to ctypes; drop the ring first
            self._ring.close()
            self._ring = None
        if getattr(self, "_buf", None) is not None:
            self._buf = None   # freed when the ctypes view is collected
