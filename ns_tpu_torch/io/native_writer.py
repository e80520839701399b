"""Async .npy writers: overlap rollout disk IO with the card's work.

Port of `ns_tpu/io/native_writer.py` (the code is the JAX package's).
`stream_rollout` (ns_tpu_torch/io/streaming.py) alternates chunks on the
card with host writes; with a synchronous writer the card idles for the IO
tail of every chunk. `AsyncNpyWriter` makes `write()` return immediately —
the copy+pwrite runs behind a bounded ring on a worker — so the disk
catches up while the NEXT chunk computes.

Backends:
  native  C++ worker thread (the port's copy of the writer,
          ns_tpu_torch/csrc/stream_writer.cpp, via ctypes; g++-compiled at
          first use into ns_tpu_torch/_build/, see runtime/native/build.py)
  thread  pure-Python worker (queue + os.pwrite, which releases the GIL)
  sync    synchronous os.pwrite on the calling thread (no overlap;
          debugging / oracle)
  auto    native if it loads, else thread (a host I/O choice; `backend`
          says which one runs)

Files are standard .npy (np.load-compatible), written at explicit frame
offsets after a pre-sized header. The reference has no streaming writer
at all (it materializes whole rollouts then np.savez once,
direct_fd/simulate.py:129-144).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np


def _pwrite_full(fd: int, data, offset: int) -> None:
    """pwrite until every byte lands (partial writes happen on full
    disks / rlimits; the C++ twin loops the same way,
    stream_writer.cpp)."""
    view = memoryview(data)
    while len(view):
        n = os.pwrite(fd, view, offset)
        if n <= 0:
            raise OSError(f"pwrite returned {n}")
        view = view[n:]
        offset += n


def _npy_header(shape, dtype) -> bytes:
    from io import BytesIO
    buf = BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
              "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


class AsyncNpyWriter:
    """Write a (n_frames, *frame_shape) .npy by asynchronous frame-range
    stores. One producer thread; call `close()` (or use as a context
    manager) to drain, fsync and finalize."""

    def __init__(self, path: str, shape, dtype=np.float32,
                 backend: str = "auto", max_buffer_bytes: int = 256 << 20):
        self.path = path
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        header = _npy_header(self.shape, self.dtype)
        self._base = len(header)
        self._frame_bytes = (int(np.prod(self.shape[1:]))
                             * self.dtype.itemsize)
        total = self._base + self.shape[0] * self._frame_bytes

        self._lib = None
        self._handle = None
        self._fd = None
        self._q = None
        self._worker = None
        self._err: list = []
        self._closed = False

        if backend == "auto":
            from ns_tpu_torch.runtime.native.build import load
            backend = "native" if load() is not None else "thread"
        self.backend = backend

        if backend == "native":
            from ns_tpu_torch.runtime.native.build import load
            lib = load()
            if lib is None:
                raise RuntimeError("native IO library unavailable "
                                   "(g++ build failed); use backend="
                                   "'thread'")
            h = lib.nsio_open(os.fsencode(path), total, max_buffer_bytes)
            if not h:
                raise OSError(f"nsio_open failed for {path!r}")
            self._lib, self._handle = lib, h
            self._submit_bytes(0, header)
        elif backend in ("thread", "sync"):
            self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                               0o644)
            os.truncate(self._fd, total)
            if backend == "thread":
                self._q = queue.Queue()
                # bound by BYTES in flight (like the C++ ring), not item
                # count: 8 queued 256 MB chunks would buffer 2 GB/field
                self._max_bytes = max_buffer_bytes
                self._buffered = 0
                self._bytes_cv = threading.Condition()
                self._worker = threading.Thread(target=self._drain,
                                                daemon=True)
                self._worker.start()
            self._submit_bytes(0, header)
        else:
            raise ValueError(f"unknown backend {backend!r}")

    # -- internals ----------------------------------------------------------

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            off, data = item
            try:
                _pwrite_full(self._fd, data, off)
            except OSError as e:  # surfaced on close()
                self._err.append(e)
            finally:
                with self._bytes_cv:
                    self._buffered -= len(data)
                    self._bytes_cv.notify_all()

    def _submit_bytes(self, offset: int, data: bytes):
        if self._lib is not None:
            rc = self._lib.nsio_submit(self._handle, offset, data,
                                       len(data))
            if rc:
                raise OSError(rc, f"native write failed for {self.path!r}")
        elif self._q is not None:
            # surface worker errors on the NEXT submit, not only at
            # close(): a failed disk must not keep accepting hours of
            # rollout (the native backend's nsio_submit does the same)
            if self._err:
                raise self._err[0]
            # backpressure on bytes in flight; a single oversized job is
            # always admitted when nothing is buffered (C++ semantics)
            with self._bytes_cv:
                while (self._buffered
                       and self._buffered + len(data) > self._max_bytes):
                    self._bytes_cv.wait()
                self._buffered += len(data)
            self._q.put((offset, data))
        else:
            _pwrite_full(self._fd, data, offset)

    # -- API ----------------------------------------------------------------

    def write(self, index: int, frames: np.ndarray):
        """Store `frames` at [index : index+len(frames)]. Returns as soon
        as the data is copied into the ring (native) / handed to the
        worker (thread)."""
        if self._closed:
            # without this, the native path would hand a NULL handle to
            # the C library (segfault) and the thread path would enqueue
            # to a dead worker (silent data loss)
            raise ValueError(f"write to closed writer for {self.path!r}")
        frames = np.ascontiguousarray(frames, dtype=self.dtype)
        if frames.shape[1:] != self.shape[1:]:
            raise ValueError(f"frame shape {frames.shape[1:]} != "
                             f"{self.shape[1:]}")
        if index < 0 or index + len(frames) > self.shape[0]:
            raise IndexError(f"frames [{index}, {index + len(frames)}) "
                             f"outside (0, {self.shape[0]})")
        off = self._base + index * self._frame_bytes
        if self._lib is not None:
            # zero-copy handoff: the C side memcpys straight from the
            # array buffer into its ring (no intermediate bytes object)
            rc = self._lib.nsio_submit(self._handle, off,
                                       frames.ctypes.data, frames.nbytes)
            if rc:
                raise OSError(rc, f"native write failed for {self.path!r}")
            return
        self._submit_bytes(off, frames.tobytes())

    def close(self):
        self._closed = True
        if self._lib is not None:
            if self._handle is None:
                return
            rc = self._lib.nsio_sync(self._handle)
            rc2 = self._lib.nsio_close(self._handle)
            self._handle = None
            if rc or rc2:
                raise OSError(rc or rc2,
                              f"native writer failed for {self.path!r}")
            return
        if self._fd is None:
            return
        if self._q is not None:
            self._q.put(None)
            self._worker.join()
            self._q = None
        os.fsync(self._fd)
        os.close(self._fd)
        self._fd = None
        if self._err:
            raise self._err[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
