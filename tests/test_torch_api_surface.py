"""The port's import paths are the JAX package's: every public name of
every module of ``skdownscale_tpu`` (outside ``ops/pallas``) and of every
subpackage's ``__all__`` exists at the same path in
``skdownscale_tpu_torch``, unless ``EXCLUDED`` names it with its reason;
and the migration shim holds the reference's 18 names, as
``tests/test_api_surface.py`` holds them for the JAX package.

A module's public names are its ``__all__`` where it has one, else the
functions and classes it defines and its upper-case constants."""

import importlib
import inspect
import pkgutil
import types

import pytest

import skdownscale_tpu

from test_api_surface import REFERENCE_ALL

# module -> names ("*": the whole module) the port leaves out, and why
EXCLUDED = {
    "skdownscale_tpu.ops.planesort": {
        "*": "dead code by design (VERDICT r5): a TPU sort by planes that nothing calls",
    },
    "skdownscale_tpu.ops.rowsort": {
        "*": "the TPU's kernel dispatch and its interpret-mode override; the port's dispatch is "
             "kernels/sort_rows.on_rows",
    },
    "skdownscale_tpu.ops": {
        "interp_sortmerge": "the TPU's gather-free lowering of interp_rows; the port's K6 takes "
                            "any table length and agrees with it bitwise",
    },
    "skdownscale_tpu.ops.interp": {
        "interp_sortmerge": "as skdownscale_tpu.ops.interp_sortmerge",
        "interp_sortmerge_multi": "as skdownscale_tpu.ops.interp_sortmerge",
    },
}
PALLAS = "skdownscale_tpu.ops.pallas"  # the TPU kernels: each has its CUDA counterpart in kernels/


def _public(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = []
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if inspect.isfunction(value) or inspect.isclass(value):
            if value.__module__ == mod.__name__:
                names.append(name)
        elif name.isupper():
            names.append(name)
    return names


def _modules() -> list:
    names = [skdownscale_tpu.__name__]
    names += [m.name for m in pkgutil.walk_packages(skdownscale_tpu.__path__, "skdownscale_tpu.")
              if not m.name.startswith(PALLAS)]
    return sorted(names)


def _port(name: str) -> str:
    return "skdownscale_tpu_torch" + name[len("skdownscale_tpu"):]


@pytest.mark.parametrize("name", _modules())
def test_every_public_name_is_at_the_same_path(name):
    excluded = EXCLUDED.get(name, {})
    if "*" in excluded:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port(name))
        return
    mod = importlib.import_module(name)
    port = importlib.import_module(_port(name))
    missing = [n for n in _public(mod) if n not in excluded and not hasattr(port, n)]
    assert not missing, f"{_port(name)} lacks {missing}"
    assert set(excluded) <= set(_public(mod)) | set(vars(mod)), "EXCLUDED names a name that is not there"


@pytest.mark.parametrize("pkg", ["skdownscale_tpu", "skdownscale_tpu.models", "skdownscale_tpu.ops",
                                 "skdownscale_tpu.utils", "skdownscale_tpu.parallel",
                                 "skdownscale_tpu.global_models"])
def test_subpackage_all_matches(pkg):
    """Each ``__all__`` lists the same names in both packages, but the
    exclusions; a callable stays callable (``ops.interp`` and ``ops.knn``
    are the functions there, as in the JAX package)."""
    mod = importlib.import_module(pkg)
    port = importlib.import_module(_port(pkg))
    want = set(mod.__all__) - set(EXCLUDED.get(pkg, {}))
    assert set(port.__all__) == want
    for n in want:
        assert callable(getattr(mod, n)) == callable(getattr(port, n)), n


def test_migration_shim():
    from skdownscale_tpu_torch import pointwise_models as pm

    assert set(pm.__all__) == set(REFERENCE_ALL)
    import skdownscale_tpu_torch as sdt

    for name in REFERENCE_ALL:
        assert getattr(pm, name) is getattr(sdt, name)


def test_excluded_modules_exist_in_the_jax_package():
    for name in EXCLUDED:
        importlib.import_module(name)
