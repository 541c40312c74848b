"""SolverEngine on the port's plain backends against their repro twins.

``reference`` against repro's ``reference`` and ``torch`` against repro's
``jnp`` (the fused-reduction forms), for every program the main path runs,
in float64 and float32, on the same seeded stack.  The ``cuda`` backend is
held to repro's ``pallas`` in ``test_torch_engine.py``.
"""

import jax

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402
from test_torch_engine import PROGRAMS, check_program, run_both  # noqa: E402
from test_torch_parity import DTYPES  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("backend", ["reference", "jnp"])
def test_plain_backends_match_repro(backend, program, dtype):
    spectrum, call = PROGRAMS[program]
    _, got, ref = run_both(backend, dtype, spectrum, call)
    check_program(program.split("_")[0], got, ref, dtype)
