"""``python -m repro_torch.obs --validate PATH`` — the trace-schema CLI.

Delegates to :func:`repro_torch.obs.trace.main`; running the package
(rather than ``python -m repro_torch.obs.trace``) avoids runpy's
double-import warning for a module the package ``__init__`` re-exports.
"""
import sys

from repro_torch.obs.trace import main

if __name__ == "__main__":
    sys.exit(main())
