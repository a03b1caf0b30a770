"""Several processes: the port's ``grayscott_tpu/utils/distributed.py``,
of which only the refusal exists yet.

JAX's ``simulate`` calls ``maybe_initialize`` first
(``grayscott_tpu/cli/simulate.py:91``): with ``GRAYSCOTT_COORDINATOR``
set, every process joins one multi-controller program, and process 0 alone
writes the output. The port has no multi-process run yet (ROADMAP.md
Queue 1 item 7.2, over ``torch.distributed``). Were it to ignore the
variable, each process would run the whole domain by itself and every one
would write the same files, so :func:`maybe_initialize` refuses it.
"""

from __future__ import annotations

import os

from ..errors import UnsupportedConfigError

#: the variable that asks for a multi-process run
COORDINATOR_VAR = "GRAYSCOTT_COORDINATOR"


def maybe_initialize() -> bool:
    """False in the single-process case (``GRAYSCOTT_COORDINATOR`` unset
    or empty); with it set, raise :class:`UnsupportedConfigError` naming
    ROADMAP.md Queue 1 item 7.2."""
    coord = os.environ.get(COORDINATOR_VAR)
    if not coord:
        return False
    raise UnsupportedConfigError(
        f"{COORDINATOR_VAR}={coord!r} asks for a multi-process run, which "
        "the port does not run yet (ROADMAP.md Queue 1 item 7.2: several "
        "processes over torch.distributed); unset it to run one process",
        combo="distributed")
