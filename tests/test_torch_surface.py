"""Every public definition of kmc_tpu has a counterpart in the port.

The sources of ``kmc_tpu/`` and ``kmc_tpu_torch/`` are read with ``ast``;
neither package is imported.  A public definition is a top-level function
or class whose name does not start with an underscore; its counterpart is
a top-level definition of the same name (a function, a class or an
assignment) in any module of the port.  Not ported, by design (ROADMAP
"Not to be ported"): ``ops/dense.py``'s one-hot gathers ``take`` and
``scatter_or_2d`` (the port uses index ops), JAX's compile cache
``utils/cache.py:enable_persistent_cache`` (the port's counterpart is the
nvcc build cache), the numpy helper ``io/writers.py:jnp_first``, and the
TPU tiling of K3, ``tiled_block_call`` and ``padded_block_call`` (the
card's kernel tiles the grid itself).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NOT_PORTED = {
    "take": "ops/dense.py",
    "scatter_or_2d": "ops/dense.py",
    "enable_persistent_cache": "utils/cache.py",
    "jnp_first": "io/writers.py",
    "tiled_block_call": "ops/pallas_lattice.py",
    "padded_block_call": "ops/pallas_lattice.py",
}


def _modules(package):
    return sorted(p.relative_to(ROOT / package).as_posix()
                  for p in (ROOT / package).rglob("*.py"))


def _public(path, assignments=False):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif assignments and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif assignments and isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port_names():
    names = set()
    for mod in _modules("kmc_tpu_torch"):
        names |= _public(ROOT / "kmc_tpu_torch" / mod, assignments=True)
    return names


@pytest.mark.parametrize("module", _modules("kmc_tpu"))
def test_public_definitions_have_counterparts(module):
    port = _port_names()
    missing = sorted(n for n in _public(ROOT / "kmc_tpu" / module)
                     if n not in port and NOT_PORTED.get(n) != module)
    assert not missing, f"kmc_tpu/{module}: no counterpart in the port " \
                        f"for {missing}"


def test_not_ported_list_is_current():
    """Each exclusion names a definition that kmc_tpu still has and that
    the port still lacks."""
    port = _port_names()
    for name, module in NOT_PORTED.items():
        assert name in _public(ROOT / "kmc_tpu" / module), (name, module)
        assert name not in port, f"{name} is ported now: drop it from " \
                                 "NOT_PORTED"
