"""The benchmark's yardstick: the cell's files, the chip's peaks, the
reading of a profiler trace and the import guard."""
