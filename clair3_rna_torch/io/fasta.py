"""FASTA reading with .fai indexing (native replacement for `samtools faidx`,
cf. shared/utils.py:168-194)."""

import os
import threading


class FastaFile:
    """Indexed FASTA access. Builds the .fai on demand if absent.

    fetch() is thread-safe (concurrent chunk builders share one handle)."""

    def __init__(self, path: str):
        self.path = path
        self._fp = open(path, "rb")
        self._lock = threading.Lock()
        fai_path = path + ".fai"
        if not os.path.exists(fai_path):
            build_fai(path, fai_path)
        self.index = {}
        self.contigs = []
        with open(fai_path) as f:
            for line in f:
                name, length, offset, linebases, linewidth = line.rstrip("\n").split("\t")[:5]
                self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                self.contigs.append(name)

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def contig_length(self, name: str) -> int:
        return self.index[name][0]

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> str:
        """0-based half-open fetch, clipped to contig bounds, uppercased."""
        length, offset, linebases, linewidth = self.index[name]
        start = max(0, start)
        end = length if end is None else min(end, length)
        if start >= end:
            return ""
        file_start = offset + (start // linebases) * linewidth + start % linebases
        file_end = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases + 1
        with self._lock:
            self._fp.seek(file_start)
            raw = self._fp.read(file_end - file_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode().upper()


def build_fai(fasta_path: str, fai_path: str | None = None) -> str:
    fai_path = fai_path or fasta_path + ".fai"
    entries = []
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        pos = 0
        for line in f:
            line_len = len(line)
            stripped = line.rstrip(b"\r\n")
            if stripped.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = stripped[1:].split()[0].decode()
                length = 0
                offset = pos + line_len
                first_line = True
            elif stripped:
                if first_line:
                    linebases = len(stripped)
                    linewidth = line_len
                    first_line = False
                length += len(stripped)
            pos += line_len
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(fai_path, "w") as out:
        for name, length, offset, linebases, linewidth in entries:
            out.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")
    return fai_path


def write_fasta(path: str, contigs: dict[str, str], line_width: int = 60) -> str:
    """Write contigs to FASTA and index it (test/synthesis helper)."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i:i + line_width] + "\n")
    build_fai(path)
    return path
