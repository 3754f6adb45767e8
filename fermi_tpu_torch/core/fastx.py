"""Streaming FASTA/FASTQ reader with transparent gzip.

Replaces the role of reference kseq.h (fresh implementation; Python-level IO is
not on the hot path — sequence batches go to device as arrays).
"""

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: Optional[str] = None
    comment: Optional[str] = None


class _GzPipeReader(io.TextIOWrapper):
    """Text stream decompressing through an external `gzip -dc` process:
    the inflate runs on its own core, overlapped with the Python parse.

    The reader that drains the stream sets `at_eof` before closing.  At EOF
    the child has closed its stdout but may not have exited yet, so close()
    then waits for it and judges its exit status; judging by poll() alone
    would read a child still exiting as an abandoned stream and lose the
    status of a corrupt or truncated input."""

    def __init__(self, path):
        import subprocess
        self._proc = subprocess.Popen(
            ["gzip", "-dc", "--", path], stdout=subprocess.PIPE, bufsize=1 << 20)
        self.at_eof = False
        super().__init__(self._proc.stdout)

    def close(self):
        try:
            super().close()
        finally:
            if not self.at_eof:
                # stream abandoned before EOF: reap without judging rc
                self._proc.kill()
                self._proc.wait()
            elif self._proc.wait() != 0:
                raise OSError(
                    f"gzip -dc exited with {self._proc.returncode}: "
                    "corrupt or truncated gzip input")


def _open_text(path: str):
    if path == "-":
        return sys.stdin
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        import shutil
        if shutil.which("gzip"):
            f.close()
            return _GzPipeReader(path)
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def _mk_record(header: str, seq: str, qual: Optional[str]) -> SeqRecord:
    body = header[1:]
    for sep in (" ", "\t"):
        if sep in body:
            name, comment = body.split(sep, 1)
            return SeqRecord(name=name, seq=seq, qual=qual, comment=comment)
    return SeqRecord(name=body, seq=seq, qual=qual, comment=None)


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Parse FASTA (multi-line ok) or FASTQ (4-line records), plain or gzipped."""
    fp = _open_text(path)
    try:
        it = iter(fp)
        header = None
        parts: list[str] = []
        for raw in it:
            line = raw.rstrip("\n")
            if header is None:
                if not line:
                    continue
                if line[0] == "@":  # FASTQ: consume exactly 3 more lines
                    seq = next(it).rstrip("\n")
                    plus = next(it).rstrip("\n")
                    if not plus.startswith("+"):
                        raise ValueError(f"{path}: malformed FASTQ near {line!r}")
                    qual = next(it).rstrip("\n")
                    yield _mk_record(line, seq, qual)
                elif line[0] == ">":
                    header = line
                    parts = []
                else:
                    raise ValueError(f"{path}: unexpected line {line!r}")
            else:
                if line[:1] == ">":
                    yield _mk_record(header, "".join(parts), None)
                    header = line
                    parts = []
                elif line[:1] == "@":
                    yield _mk_record(header, "".join(parts), None)
                    header = None
                    seq = next(it).rstrip("\n")
                    plus = next(it).rstrip("\n")
                    qual = next(it).rstrip("\n")
                    yield _mk_record(line, seq, qual)
                else:
                    parts.append(line)
        if isinstance(fp, _GzPipeReader):
            fp.at_eof = True
        if header is not None:
            yield _mk_record(header, "".join(parts), None)
    finally:
        if fp is not sys.stdin:
            fp.close()
