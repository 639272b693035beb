"""Concatenate per-chunk output files by prefix (src/concat_files.py:37-64)."""

import os


def concat_files(input_dir, output_fn, prefix=None, suffix=None,
                 skip_header_after_first=True):
    files = sorted(
        fn for fn in os.listdir(input_dir)
        if (prefix is None or fn.startswith(prefix))
        and (suffix is None or fn.endswith(suffix)))
    wrote_header = False
    with open(output_fn, "w") as out:
        for fn in files:
            with open(os.path.join(input_dir, fn)) as f:
                for line in f:
                    if line.startswith("#") and skip_header_after_first:
                        if wrote_header:
                            continue
                    out.write(line)
            wrote_header = True
    return output_fn, len(files)
