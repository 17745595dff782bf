"""Error model for the TPU-native JPEG engine.

Mirrors the reference error taxonomy (common.h:15-31) as a Python exception
hierarchy instead of C return codes.  Every failure mode the reference can
report maps onto one of these exception classes; the CLI drivers translate
them back into nonzero exit codes the way the reference `main()` does.
"""

from __future__ import annotations


class JpegError(Exception):
    """Base class for all engine errors (analog of nonzero return codes)."""

    code = 0x3000


class FileIOError(JpegError):
    """I/O error (reference: RET_FAILURE_FILE_IO, common.h:19)."""

    code = 0x1000


class UnsupportedError(JpegError):
    """Unsupported feature or file type (RET_FAILURE_FILE_UNSUPPORTED)."""

    code = 0x1001


class FileOpenError(JpegError):
    """File open failure (RET_FAILURE_FILE_OPEN)."""

    code = 0x1002


class FileSeekError(JpegError):
    """Seek failure (RET_FAILURE_FILE_SEEK)."""

    code = 0x1003


class AllocationError(JpegError):
    """Memory allocation failure (RET_FAILURE_MEMORY_ALLOCATION)."""

    code = 0x2000


class LogicError(JpegError):
    """Faulty internal logic (RET_FAILURE_LOGIC_ERROR)."""

    code = 0x3000


class OverflowError_(JpegError):
    """Result too large for destination type (RET_FAILURE_OVERFLOW_ERROR)."""

    code = 0x3001


class NoMoreData(JpegError):
    """End of entropy-coded segment / stream (RET_FAILURE_NO_MORE_DATA).

    Unlike the other classes this is frequently *control flow*, not an
    error: the reference uses it to detect the end of an ECS
    (io.c:247-274 bubbling up through decoder.c:376-382).  The decoder
    catches it internally; it only escapes on genuinely truncated input.
    """

    code = 0x4000


class CorruptStream(JpegError):
    """Corrupted JPEG stream detected mid-decode (decoder.c:339-347)."""

    code = 0x4001
