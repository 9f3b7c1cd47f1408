"""The JAX package's host-lane library, for the port's comparison tests.

Several JAX test modules ask ``native.available()`` when they are
imported, and every pytest-xdist worker imports every test module to
collect it. On a fresh checkout each worker therefore compiles
``native/build/libhostpath.so`` at the same moment, each straight into
the final path. A worker that opens the file while another worker's
compiler is still writing it records the load as failed ("file too
short", "invalid ELF header") and keeps that failure for its life, so
every comparison test it runs later fails before it compares anything.

``jax_host_lane`` loads the library again once the writers are done. The
port test modules that build a JAX ``NativeRlsPipeline`` import the
autouse fixture ``jax_reference_lane``, which calls it once a module. A
failure of any other kind raises at once, and so does a library still
unreadable after ``timeout`` seconds. ``jax_ingress`` and the fixture
``jax_reference_ingress`` do the same for the JAX package's HTTP/2
ingress (``native/build/libh2ingress.so``).
"""

import time

import pytest

from limitador_tpu import native as jax_native

#: dlopen errors of a shared object that is still being written
_PARTIAL = ("file too short", "invalid ELF header")


def jax_host_lane(timeout: float = 300.0, tick: float = 0.5):
    """The loaded JAX host-lane library (``limitador_tpu.native``)."""
    deadline = time.monotonic() + timeout
    while not jax_native.available():
        error = jax_native.build_error() or ""
        if not any(mark in error for mark in _PARTIAL):
            raise RuntimeError(f"the JAX host lane did not build: {error}")
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"the JAX host lane stayed unreadable for {timeout} s: "
                f"{error}"
            )
        time.sleep(tick)
        # the loader keeps its first failure; let the next call try again
        jax_native._LIB._build_error = None
    return jax_native


@pytest.fixture(autouse=True, scope="module")
def jax_reference_lane():
    """``jax_host_lane`` before the first test of the importing module."""
    jax_host_lane()


def jax_ingress(timeout: float = 300.0, tick: float = 0.5):
    """The JAX package's ingress module with its library loaded
    (``native/build/libh2ingress.so``), after the same wait: the JAX
    ingress tests compile it at collection in every worker."""
    from limitador_tpu.native import ingress

    deadline = time.monotonic() + timeout
    while not ingress.ingress_available():
        error = ingress.ingress_build_error() or ""
        if not any(mark in error for mark in _PARTIAL):
            raise RuntimeError(f"the JAX ingress did not build: {error}")
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"the JAX ingress stayed unreadable for {timeout} s: "
                f"{error}"
            )
        time.sleep(tick)
        ingress._LIB._build_error = None
    return ingress


@pytest.fixture(autouse=True, scope="module")
def jax_reference_ingress():
    """``jax_ingress`` before the first test of the importing module."""
    jax_ingress()
