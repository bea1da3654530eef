"""The port's package surfaces: `alchemy_tpu_torch`, `.nt`, `.she` and
`.parallel` export the names of the JAX package's `__all__`s, each
resolving to the port's counterpart (same name, defined in the port), and
`__version__`."""

import importlib
import types

import pytest

PACKAGES = ["", ".nt", ".she", ".parallel"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_surface_matches_the_jax_package(sub):
    ref = importlib.import_module("alchemy_tpu" + sub)
    port = importlib.import_module("alchemy_tpu_torch" + sub)
    assert port.__all__ == ref.__all__
    for name in ref.__all__:
        want, got = getattr(ref, name), getattr(port, name)
        if isinstance(want, types.ModuleType):
            assert got.__name__ == want.__name__.replace("alchemy_tpu", "alchemy_tpu_torch", 1)
        else:
            assert got.__module__.split(".")[0] == "alchemy_tpu_torch", name
            assert got.__qualname__ == want.__qualname__, name
            assert got.__module__ == want.__module__.replace("alchemy_tpu", "alchemy_tpu_torch", 1)


def test_version_matches():
    import alchemy_tpu
    import alchemy_tpu_torch

    assert alchemy_tpu_torch.__version__ == alchemy_tpu.__version__


@pytest.mark.parametrize("sub", [".native", ".utils", ".utils.profiling"])
def test_tooling_functions_match_the_jax_package(sub):
    """The JAX `native` and `utils` modules have no `__all__`: each of
    their public functions is in the port's module under its name, with
    its signature (`phase` is the examples' `timed` in both)."""
    import inspect

    ref = importlib.import_module("alchemy_tpu" + sub)
    port = importlib.import_module("alchemy_tpu_torch" + sub)
    names = sorted(n for n, v in vars(ref).items()
                   if not n.startswith("_") and inspect.isfunction(v)
                   and v.__module__.startswith("alchemy_tpu."))
    assert names == sorted(n for n, v in vars(port).items()
                           if not n.startswith("_") and inspect.isfunction(v)
                           and v.__module__.startswith("alchemy_tpu_torch.")
                           and n in names)
    for name in names:
        want, got = getattr(ref, name), getattr(port, name)
        assert got.__module__.split(".")[0] == "alchemy_tpu_torch", name
        assert got.__qualname__ == want.__qualname__, name
        assert inspect.signature(got) == inspect.signature(want), name
