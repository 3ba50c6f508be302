"""Schema validator CLI for obs JSONL files.

    python -m repro_torch.obs.validate OBS_DIR_OR_FILE [...]

A copy of ``repro.obs.validate``. Exits non-zero if any record fails
:func:`repro_torch.obs.recorder.validate_record` (or any line is not valid
JSON), so a schema regression fails a run instead of shipping an
unreadable chart.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, List, Tuple

from repro_torch.obs.recorder import validate_record


def iter_jsonl_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, f) for f in sorted(os.listdir(p))
                       if f.endswith(".jsonl"))
        else:
            out.append(p)
    return out


def validate_file(path: str) -> Tuple[int, List[str]]:
    """Returns (n_records, errors)."""
    errors: List[str] = []
    n = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.strip():
                continue
            n += 1
            try:
                rec = json.loads(line)
            except ValueError as e:
                errors.append(f"{path}:{lineno}: not JSON ({e})")
                continue
            for err in validate_record(rec):
                errors.append(f"{path}:{lineno}: {err}")
    return n, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="obs dir(s) or .jsonl file(s)")
    ap.add_argument("--max-errors", type=int, default=20,
                    help="report at most this many violations")
    args = ap.parse_args(argv)

    files = iter_jsonl_files(args.paths)
    if not files:
        print(f"obs.validate: no .jsonl files under {args.paths}", file=sys.stderr)
        return 1
    total = 0
    all_errors: List[str] = []
    for f in files:
        n, errs = validate_file(f)
        total += n
        all_errors.extend(errs)
        status = "OK" if not errs else f"{len(errs)} violations"
        print(f"obs.validate: {f}: {n} records, {status}")
    if all_errors:
        for e in all_errors[:args.max_errors]:
            print(f"  {e}", file=sys.stderr)
        extra = len(all_errors) - args.max_errors
        if extra > 0:
            print(f"  ... and {extra} more", file=sys.stderr)
        return 1
    print(f"obs.validate: {total} records across {len(files)} files, all valid")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
