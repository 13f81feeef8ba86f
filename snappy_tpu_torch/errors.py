"""Sentinel error catalog for snappy_tpu_torch (the port's copy of
``snappy_tpu/errors.py``: the same classes, messages and exit codes).

The reference centralizes its error surface in one module with sentinel
values and structured error types (reference: snappy/errors.go:26-248).
We mirror that discipline: every error the codec can raise is defined
here, once, with a stable message, so the CLI exit-code contract and the
tests can match on identity rather than string-parsing.
"""


class SnappyError(Exception):
    """Base class for all snappy_tpu_torch errors."""


class CorruptError(SnappyError):
    """The compressed stream is malformed.

    Raised for: bad tag, zero offset, offset reaching before the start of
    the block, length overrunning the declared uncompressed size, varint
    preamble longer than 5 bytes, or a decoded size that does not match
    the preamble.  (Mirrors golang-snappy ErrCorrupt semantics; see
    SURVEY.md §8.3.)
    """

    def __init__(self, detail: str = ""):
        super().__init__(f"snappy: corrupt input{': ' + detail if detail else ''}")
        self.detail = detail


class TooLargeError(SnappyError):
    """Declared uncompressed length exceeds 2**32 - 1."""

    def __init__(self, length: int = -1):
        super().__init__(f"snappy: decoded block is too large ({length})")
        self.length = length


class UnsupportedError(SnappyError):
    """Stream uses a reserved unskippable chunk type (framed format)."""

    def __init__(self, chunk_type: int = -1):
        super().__init__(
            f"snappy: unsupported input (reserved unskippable chunk type 0x{chunk_type:02x})"
        )
        self.chunk_type = chunk_type


class ChecksumError(SnappyError):
    """A framed chunk's masked CRC-32C does not match its payload.

    actual=None means the verifier reported only the mismatch, not the
    recomputed value (the device CRC kernel returns an error flag;
    the native decoder reports only the error code).  expected=None
    means the stored value was not surfaced either."""

    def __init__(self, expected: int | None = None,
                 actual: int | None = None):
        stored = ("stored value not surfaced" if expected is None
                  else f"stored 0x{expected:08x}")
        got = ("verifier reported mismatch only" if actual is None
               else f"computed 0x{actual:08x}")
        super().__init__(f"snappy: checksum mismatch ({stored}, {got})")
        self.expected = expected
        self.actual = actual


class BadMagicError(CorruptError):
    """Framed stream does not begin with the sNaPpY stream identifier."""

    def __init__(self):
        super().__init__("framed stream missing sNaPpY identifier")


# CLI exit codes (reference keeps a single root-cause → exit-code mapping in
# cmd/snappy/main.go; we do the same).
EXIT_OK = 0
EXIT_USAGE = 2
EXIT_CORRUPT = 3
EXIT_CHECKSUM = 4
EXIT_UNSUPPORTED = 5
EXIT_TOO_LARGE = 6

EXIT_CODE_FOR = {
    CorruptError: EXIT_CORRUPT,
    BadMagicError: EXIT_CORRUPT,
    ChecksumError: EXIT_CHECKSUM,
    UnsupportedError: EXIT_UNSUPPORTED,
    TooLargeError: EXIT_TOO_LARGE,
}


def exit_code_for(exc: BaseException) -> int:
    for klass in type(exc).__mro__:
        if klass in EXIT_CODE_FOR:
            return EXIT_CODE_FOR[klass]
    return 1
