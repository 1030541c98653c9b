"""CLI entry: ``python -m repro_torch.analysis [--json] [PATHS]``, exit 0 iff
clean."""
import sys

from .runner import main

if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # downstream pager/head closed the pipe mid-report; exit quietly but
        # still nonzero — a truncated report must not read as "clean"
        sys.stderr.close()
        rc = 1
    sys.exit(rc)
