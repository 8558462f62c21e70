"""Repository-wide pytest setup: TPU interpret mode waits for its callbacks.

JAX runs a Pallas TPU kernel in interpret mode (on the CPU) through host
callbacks on a thread of their own, and those callbacks dispatch JAX work
themselves. A test that leaves ``pltpu.force_tpu_interpret_mode()`` and
dispatches more JAX work while the callbacks of its kernel still run can
deadlock the process now and then: the callback thread and the main thread
each wait on the other's dispatch (seen in
``tests/test_pallas_warp.py::test_pallas_warp_matches_gather``, whose worker
then sits idle until the run's time limit).

Every test reaches the context manager as the attribute
``jax.experimental.pallas.tpu.force_tpu_interpret_mode``. This file replaces
that attribute with a context manager that enters the original and, on its
way out (normally or by an exception), calls ``jax.effects_barrier()``, which
returns once every pending callback has run. Nothing else changes: the same
kernels run on the same inputs with the same checks.

The replacement is made in ``pytest_configure``, after ``tests/conftest.py``
has set JAX's 8-device CPU platform: importing JAX's Pallas modules earlier
could fix the platform before that.
"""

import contextlib
import functools


def _waiting_for_callbacks(force_interpret):
    @functools.wraps(force_interpret)
    @contextlib.contextmanager
    def force_tpu_interpret_mode(*args, **kwargs):
        import jax

        try:
            with force_interpret(*args, **kwargs):
                yield
        finally:
            jax.effects_barrier()

    force_tpu_interpret_mode.waits_for_callbacks = True
    return force_tpu_interpret_mode


def pytest_configure(config):
    from jax.experimental.pallas import tpu as pltpu

    if not getattr(pltpu.force_tpu_interpret_mode, "waits_for_callbacks", False):
        pltpu.force_tpu_interpret_mode = _waiting_for_callbacks(pltpu.force_tpu_interpret_mode)
