"""``python -m hops_tpu_torch.analysis`` — run graftlint (see :mod:`.cli`).
(counterpart of ``hops_tpu/analysis/__main__.py``)

The ``__name__`` guard matters: the import drift-guard sweep imports
this module as ``hops_tpu_torch.analysis.__main__`` and must not trigger a
lint run with pytest's argv.
"""

import sys

from hops_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:
        # ``--graph lock | head`` closes stdout early; that's the
        # reader's choice, not an error worth a traceback.
        sys.stderr.close()
        code = 0
    sys.exit(code)
