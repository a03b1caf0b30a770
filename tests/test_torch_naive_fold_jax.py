"""The folded naive reaction and ``naive_fix`` ``store``/``slice`` in the
port against JAX's interpret-mode runs (tests/test_torch_naive_fold.py has
the default stencil's float32 runs and the plain checks): the fold on the
direct plan (5points) in float32 and on bf16 storage, both engines, after 8
and 16 steps, at atol 1e-6 and one bf16 ulp; ``store`` and ``slice``, which
the port runs on its exact path, at 1e-6 after 16 steps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_uv
from test_torch_naive_fold import (ENGINES, SHAPES, check_against_jax,
                                   jax_run, port_run)

CASES = ([(shape, "5points", engine, "float32")
          for shape in SHAPES[1:3] for engine in ENGINES]
         + [(shape, "oono-puri", engine, "bfloat16")
            for shape in SHAPES[:2] for engine in ENGINES])


@pytest.mark.parametrize("shape,stencil_name,engine,dtype", CASES)
def test_fold_matches_jax(rng, shape, stencil_name, engine, dtype):
    check_against_jax(rng, shape, stencil_name, engine, dtype)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("naive_fix", ["store", "slice"])
def test_naive_fix_matches_jax(rng, naive_fix, engine):
    """The port's exact path against JAX's ``store`` and ``slice`` runs in
    interpret mode, after 16 steps: 1e-6."""
    u, v = random_uv(rng, (32, 16))
    (got,), (want,) = (run(u, v, [16], engine=engine, naive_fix=naive_fix)
                       for run in (port_run, jax_run))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
